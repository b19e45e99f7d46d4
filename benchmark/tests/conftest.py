"""The benchmark's tests import it as ``benchmark``, from the checkout's root.

``app_root`` is a checkout whose ``BENCHMARK.json`` also declares the app cell
(``app_cell.json``: its configuration, cell and the per-layer metrics it
reports), which the committed benchmark leaves out for its spread between runs;
its loop, configuration, mix and readers are the benchmark's own files."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def declare(bench: dict, extra: dict) -> dict:
    """``bench`` with the configurations, cells and metrics of ``extra`` added; a
    metric ``bench`` already has takes ``extra``'s cells into its ``workloads``."""
    out = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "per_layer"):
        have = {x["name"]: x for x in out[key]}
        for x in extra[key]:
            if x["name"] not in have:
                out[key].append(x)
            elif key == "per_layer":
                cells = have[x["name"]]["workloads"]
                cells += [c for c in x["workloads"] if c not in cells]
    return out


@pytest.fixture(scope="session")
def app_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    os.symlink(os.path.join(ROOT, "benchmark"), root / "benchmark")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "tests", "app_cell.json")) as f:
        extra = json.load(f)
    (root / "BENCHMARK.json").write_text(json.dumps(declare(bench, extra)))
    return str(root)
