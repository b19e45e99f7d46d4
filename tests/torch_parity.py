"""Shared set-up of the parity tests between raytracer_tpu (JAX) and raytracer_tpu_torch.

Both packages get identical inputs: scenes come from the JAX ``ScenePacker`` and
reach the port through ``scene_from_numpy``; rays and other inputs are numpy
arrays made from a seed.  The JAX side runs on the CPU (tests/conftest.py) under
its lossless profile with one chunk, which is the port's semantics.
"""

import contextlib
import os

import jax
import numpy as np
import torch

from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu.scene import scenes as jax_scenes
from raytracer_tpu.scene.device import ScenePacker as JaxPacker
from raytracer_tpu_torch.config import RenderConfig as TorchConfig
from raytracer_tpu_torch.scene.tensors import scene_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The suite runs several pytest workers at once on a few cores; torch's own
# thread pool on top of that oversubscribes them and slows every worker.  The
# parity tests use tiny tensors, for which one thread is enough.
torch.set_num_threads(1)

# config3 cut to test size: the procedural Sponza stand-in at 20k triangles
CONFIG3_TINY = dict(width=64, height=36, target_triangles=20_000)
CONFIG1_TINY = dict(width=32, height=32)


@contextlib.contextmanager
def private_bvh_cache():
    """Build scenes with this process's own BLAS disk cache.  Both packages cache
    BLASes under a path relative to the working directory, written without a
    lock, and test workers that build the same mesh at once would write the same
    file; a per-process working directory (gitignored) keeps them apart."""
    d = os.path.join(REPO, ".cache", f"torch_parity_{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    old = os.getcwd()
    os.chdir(d)
    try:
        yield
    finally:
        os.chdir(old)


def jax_scene(name: str):
    """(JAX DeviceScene, lossless JAX RenderConfig) of a test-size scene."""
    with private_bvh_cache():
        return _jax_scene(name)


def _jax_scene(name: str):
    if name == "config3":
        w, h = CONFIG3_TINY["width"], CONFIG3_TINY["height"]
        desc, cfg = jax_scenes.config3_sponza(
            w, h, target_triangles=CONFIG3_TINY["target_triangles"])
    else:
        w, h = CONFIG1_TINY["width"], CONFIG1_TINY["height"]
        desc, cfg = jax_scenes.make_scene(name)
    cfg = jax_renderer.lossless_fallback_config(
        cfg.replace(width=w, height=h, traversal_chunk=max(cfg.traversal_chunk, w * h))
    )
    return JaxPacker(desc, w, h).frame(), cfg


def fields(scene) -> dict:
    return {k: np.array(v) for k, v in scene._asdict().items()}


def torch_scene(scene):
    """The port's CPU tensors of a JAX DeviceScene."""
    return scene_from_numpy(fields(scene), device="cpu")


def torch_config(cfg) -> TorchConfig:
    """The port's copy of a JAX RenderConfig, knob for knob."""
    return TorchConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def jit(fn):
    return jax.jit(fn)
