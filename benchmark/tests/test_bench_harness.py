"""The harness: BENCHMARK.json as the contract states it, every file found by name,
a new cell taken up from new files alone, and the result's line."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL = "sponza_1080p_threaded.flythrough"  # a cell BENCHMARK.json declares
TINY = {"dynamic_900x600.app": {"resolution": [90, 60]},
        "sponza_1080p_threaded.flythrough": {"resolution": [48, 27], "triangles": 20000}}


@pytest.fixture(params=["committed", "with_app_cell"])
def bench(request, app_root):
    """The committed BENCHMARK.json, and the same with the app cell declared."""
    return harness.benchmark(ROOT if request.param == "committed" else app_root)


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        cfg = harness.configuration(bench, c["name"])
        assert c["file"].startswith("benchmark/configs/")
        assert set(c["reduced"]) <= set(cfg["assumed"]) and cfg["reduced"] == c["reduced"]
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        m = harness.mix(w["traffic"])
        assert harness.loop_class(m["loop"]) is not None
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for x in bench["per_layer"]:
        r = harness.reader(x["name"])
        assert (r.NAME, r.UNIT, r.LAYER, r.MOVES) == (x["name"], x["unit"], x["layer"],
                                                      x["moves"])
        assert x["moves"] in e2e
        for cell in x.get("workloads", []):
            harness.workload(bench, cell)
            assert harness.applies(e2e[x["moves"]], cell)


def test_a_new_cell_is_taken_up_from_new_files_alone(tmp_path, app_root):
    bench = harness.benchmark(app_root)
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    app = json.loads((root / "benchmark/mixes/app.json").read_text())
    (root / "benchmark/mixes/app_slow.json").write_text(json.dumps({**app, "dt": 1 / 30}))
    cfg = json.loads((root / "benchmark/configs/dynamic_900x600.json").read_text())
    (root / "benchmark/configs/dynamic_450x300.json").write_text(
        json.dumps({**cfg, "resolution": [450, 300]}))
    (root / "benchmark/metrics/present_ms.app.py").write_text(
        'NAME, UNIT, LAYER, MOVES = "present_ms.app", "ms", "render.renderer", "frame_ms"\n'
        "def read(ctx):\n    ms = ctx.spans.get('present')\n"
        "    return sum(ms) / len(ms) if ms else None\n")
    dynamic = [c for c in bench["configs"] if c["name"] == "dynamic_900x600"][0]
    new["configs"].append({**dynamic, "name": "dynamic_450x300",
                           "file": "benchmark/configs/dynamic_450x300.json"})
    new["workloads"].append({"name": "dynamic_450x300.app_slow", "config": "dynamic_450x300",
                             "traffic": "app_slow", "chips": 1, "why": "a test cell"})
    new["per_layer"].append({"name": "present_ms.app", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "render.renderer",
                             "moves": "frame_ms", "workloads": ["dynamic_450x300.app_slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    b = harness.benchmark(str(root))
    w = harness.workload(b, "dynamic_450x300.app_slow")
    assert harness.configuration(b, w["config"], str(root))["resolution"] == [450, 300]
    assert harness.mix(w["traffic"], str(root))["dt"] == 1 / 30
    assert harness.reader("present_ms.app", str(root)).NAME == "present_ms.app"
    # the whole cell runs, tiny, from the copy, with no other file changed
    result = harness.run("dynamic_450x300.app_slow", 7, 0.5, True, device="cpu",
                         overrides={"resolution": [45, 30]}, root=str(root))
    assert result["correct"] and "present_ms.app" in result["metrics"]
    assert "host_ms.app" not in result["metrics"]  # its workloads name other cells


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape_and_frame_ms(trace, app_root):
    result = harness.run("dynamic_900x600.app", 2**31 + 99, 0.5, trace, device="cpu",
                         overrides=TINY["dynamic_900x600.app"], root=app_root)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k, v in result["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"], k
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "host_ms.app" in result["metrics"] and "frame_ms" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
        # the window's length over the frames completed in it
        frame_ms = result["metrics"]["frame_ms"]["value"]
        assert frame_ms == pytest.approx(result["timing"]["window_s"] * 1e3
                                         / result["attempted"], rel=1e-12)
        assert result["timing"]["window_s"] >= 0.5
        # the tail is over every frame of the window
        assert result["timing"]["frames_timed"] == result["attempted"]
        assert result["metrics"]["frame_ms_p95"]["value"] <= result["timing"]["window_s"] * 1e3
    assert set(result["host"]) == {"cpus", "own_cpu"} and result["host"]["own_cpu"] > 0


def test_tail_is_the_95th_percentile_of_every_frame():
    times = [10.0] * 95 + [50.0] * 5
    assert harness.tail_ms(times) == pytest.approx(48.0)
    assert harness.tail_ms(list(range(1, 101))) == pytest.approx(95.95)
    assert harness.tail_ms([7.0]) == 7.0


def test_frame_clock_times_each_frame():
    import time

    clock = harness.FrameClock(cuda=False)
    clock.mark()
    for _ in range(3):
        time.sleep(0.01)
        clock.mark()
    times = clock.times_ms()
    assert len(times) == 3 and all(9.0 <= t < 200.0 for t in times)


def test_launches_are_counted_inside_their_span():
    """A traced span synchronises at both ends, so a device event belongs to the
    span whose host range holds its start; events of other spans are not counted."""
    import numpy as np

    from benchmark import tracing

    p = tracing.Profile.__new__(tracing.Profile)
    p.frames = 2
    p.device = [("k", 10.0, 1.0), ("k", 12.0, 1.0), ("copy", 25.0, 2.0), ("k", 40.0, 1.0)]
    p.host = (np.array([5.0, 20.0, 35.0]), np.array([15.0, 30.0, 45.0]),
              np.array(["render", "app.host", "render"], dtype=object))
    assert [e[1] for e in p.launched_in("render")] == [10.0, 12.0, 40.0]
    ctx = harness.SimpleNamespace(profile=p)
    assert harness.reader("launches_per_frame.render").read(ctx) == 1.5
    assert harness.reader("launches_per_frame.app").read(ctx) == 0.5


def test_no_result_without_the_card(tmp_path):
    """Without CUDA the run prints nothing on standard output and exits with 3."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                        "--workload", CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert p.returncode == 3 and p.stdout == "" and "CUDA" in p.stderr


def test_no_result_outside_a_checkout(tmp_path):
    """With only BENCHMARK.json and the benchmark's own files, the run fails."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, str(tmp_path / "benchmark" / "run.py"),
                        "--workload", CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout == ""
