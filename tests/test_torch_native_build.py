"""The port's native SBVH builder loads safely when processes race for it
(``raytracer_tpu_torch/accel/native.py:_load``): one process compiles under a
lock and renames the library into place, the others load the finished file; a
library that does not load is rebuilt; a build that fails while g++ is present
raises instead of switching to the numpy builder."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from raytracer_tpu_torch.accel import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

# a child process: point the builder at the given library path, load it, build
# the SBVH of a seeded triangle soup, print "native|numpy <digest of the BVH>"
CHILD = r"""
import hashlib, sys
import numpy as np
from raytracer_tpu_torch.accel import native
native._SO = sys.argv[1]
rng = np.random.default_rng(0)
p = rng.uniform(-1.0, 1.0, (3, 200, 3))
bvh = native.build_native(p[0], p[0] + 0.1 * p[1], p[0] + 0.1 * p[2], spatial=True)
if bvh is None:
    print("numpy -")
else:
    h = hashlib.sha256()
    for a in (bvh.node_min, bvh.node_max, bvh.node_left, bvh.node_count, bvh.prim_order):
        h.update(np.ascontiguousarray(a).tobytes())
    print("native", h.hexdigest())
"""


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One library compiled for the whole file (the others copy or cut it)."""
    so = str(tmp_path_factory.mktemp("sbvh_built") / "libsbvh.so")
    native._compile(native._SRC, so)
    return so


@pytest.fixture
def fresh(monkeypatch):
    """The module's load state cleared, restored afterwards."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)


def test_concurrent_loads_all_get_the_native_builder(tmp_path):
    so = str(tmp_path / "build" / "libsbvh.so")  # absent: the first process builds it
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, so], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
    assert all(o[0] == "native" for o in outs), outs
    assert len({o[1] for o in outs}) == 1, outs
    # one library in place, no temporary file left beside it
    assert sorted(os.listdir(tmp_path / "build")) == ["libsbvh.so", "libsbvh.so.lock"]


def test_truncated_library_is_rebuilt(tmp_path, built, fresh, monkeypatch):
    so = str(tmp_path / "libsbvh.so")
    with open(built, "rb") as f:
        head = f.read(4096)
    with open(so, "wb") as f:
        f.write(head)  # newer than the source, so not stale: only loading finds it bad
    monkeypatch.setattr(native, "_SO", so)
    assert native.available()
    assert os.path.getsize(so) > len(head)
    rng = np.random.default_rng(1)
    p = rng.uniform(-1.0, 1.0, (3, 50, 3)).astype(np.float32)
    assert native.build_native(p[0], p[1], p[2], spatial=True) is not None


def test_failed_build_with_gxx_raises(tmp_path, fresh, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libsbvh.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()
    assert not native._lib_failed  # no silent switch to the numpy builder
    assert not os.path.exists(tmp_path / "libsbvh.so")
