"""Nothing a benchmark run imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``raytracer_tpu`` (compared whole: ``raytracer_tpu_torch`` begins
with ``raytracer_tpu``)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark import harness


def test_no_source_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(os.path.join(harness.ROOT, "benchmark")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in harness.BLOCKED, (f, n)


def test_a_run_loads_no_jax(app_root):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "from benchmark import harness\n"
        "r = harness.run('dynamic_900x600.app', 3, 0.2, True, device='cpu',\n"
        f"                overrides={{'resolution': [30, 20]}}, root={app_root!r})\n"
        "print(json.dumps({'correct': r['correct'], 'blocked': harness.blocked_modules(),\n"
        "                  'port': 'raytracer_tpu_torch' in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "blocked": [], "port": True}


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracer_tpu_torch_x", sys)
    assert harness.blocked_modules() == []
    monkeypatch.setitem(sys.modules, "raytracer_tpu.render", sys)
    assert harness.blocked_modules() == ["raytracer_tpu.render"]
