"""The port imports neither JAX nor the JAX package, and its entry points run on
``cuda`` unless asked for the CPU."""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "raytracer_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "raytracer_tpu")


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_import(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda():
    from raytracer_tpu_torch import devices
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render.renderer import Renderer

    assert devices.resolve("cpu").type == "cpu"
    assert Renderer(RenderConfig(), device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert Renderer(RenderConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Renderer(RenderConfig())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            devices.resolve()
