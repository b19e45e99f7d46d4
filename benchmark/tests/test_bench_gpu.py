"""Each declared cell once on the card, short, through ``benchmark/run.py``: run
``python3 -m pytest benchmark/tests -m gpu`` on a machine with a CUDA card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(harness.ROOT, "benchmark", "run.py"),
                        "--workload", cell, "--seed", str(2**31 + 17), "--seconds", "2",
                        "--trace", str(trace)], capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["metrics"]
