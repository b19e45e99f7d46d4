"""Shared set-up of the parity tests between raytracer_tpu (JAX) and raytracer_tpu_torch.

Both packages get identical inputs: scenes come from the JAX ``ScenePacker`` and
reach the port through ``scene_from_numpy``; rays and other inputs are numpy
arrays made from a seed.  The JAX side runs on the CPU (tests/conftest.py) under
its lossless profile with one chunk, which is the port's semantics.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.diff import train as jax_train
from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu.scene import scenes as jax_scenes
from raytracer_tpu.scene.device import ScenePacker as JaxPacker
from raytracer_tpu_torch.config import RenderConfig as TorchConfig
from raytracer_tpu_torch.diff import train
from raytracer_tpu_torch.render import renderer
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


def _lossless(cfg, w, h, **changes):
    """The JAX lossless profile at w x h in one chunk: the port's semantics."""
    return jax_renderer.lossless_fallback_config(
        cfg.replace(width=w, height=h, traversal_chunk=max(cfg.traversal_chunk, w * h),
                    **changes)
    )


def _jax_scene(name: str):
    if name == "config3":
        w, h = CONFIG3_TINY["width"], CONFIG3_TINY["height"]
        desc, cfg = jax_scenes.config3_sponza(
            w, h, target_triangles=CONFIG3_TINY["target_triangles"])
    else:
        w, h = CONFIG1_TINY["width"], CONFIG1_TINY["height"]
        desc, cfg = jax_scenes.make_scene(name)
    return JaxPacker(desc, w, h).frame(), _lossless(cfg, w, h)


def jax_frames(name: str, width: int, height: int, updates=(0,), **changes):
    """([JAX DeviceScene of the frame after k animation steps of 1/60 s, for k in
    ``updates``], lossless JAX RenderConfig) of ``make_scene(name)`` at
    width x height, with ``changes`` to its config."""
    with private_bvh_cache():
        desc, cfg = jax_scenes.make_scene(name)
        packer = JaxPacker(desc, width, height)
        frames, done = [], 0
        for k in updates:
            while done < k:
                desc.update(1.0 / 60.0)
                done += 1
            frames.append(packer.frame())
    return frames, _lossless(cfg, width, height, **changes)


def seeded_target(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (cfg.height, cfg.width, 3)).astype(np.float32)


def masked_grads(scene, cfg, seed=21) -> dict:
    """JAX and port (loss, {field: grad}) of the mean squared error against a
    seeded target, over the 17 differentiable fields of a JAX DeviceScene, with
    the loss masked to the pixels whose forward images agree within 1e-3
    (ROADMAP C1); ``n_masked`` counts the pixels left out."""
    target = seeded_target(cfg, seed)
    params = jax_train.extract_params(scene)

    def masked_loss(p, mask):
        img, _ = jax_renderer.render_with_stats(jax_train.apply_params(scene, p), cfg)
        se = jnp.where(mask[..., None], (img - target) ** 2, 0.0)
        return jnp.sum(se) / (jnp.sum(mask) * 3), img

    # one program; the first run (nothing masked) gives the forward image
    vg = jax.jit(jax.value_and_grad(masked_loss, has_aux=True))
    all_px = np.ones((cfg.height, cfg.width), bool)
    (_, jimg), _ = vg(params, all_px)

    tscene, tcfg = torch_scene(scene), torch_config(cfg)
    with torch.no_grad():
        timg, _ = renderer.render_with_stats(tscene, tcfg)
    mask = np.abs(np.asarray(jimg) - timg.numpy()).max(axis=-1) <= 1e-3
    (jloss, _), jgrads = vg(params, mask)

    tparams = train.extract_params(tscene)
    img, _ = renderer.render_with_stats(train.apply_params(tscene, tparams), tcfg)
    m = torch.from_numpy(mask)
    se = torch.where(m[..., None], (img - torch.from_numpy(target)) ** 2, 0.0)
    loss = se.sum() / (m.sum() * 3)
    loss.backward()
    return dict(
        n_masked=int((~mask).sum()),
        jax=(float(jloss), {k: np.asarray(v) for k, v in jgrads.items()}),
        port=(float(loss.detach()),
              {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().numpy()
               for k, p in tparams.items()}),
    )


def l2rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb > 0 else float(np.linalg.norm(a))


def grad_mismatches(grads: dict, tol: dict) -> dict:
    """{field: l2-relative error} of the port's gradients against JAX's where it
    exceeds ``tol[field]`` (``tol["*"]`` for the rest); asserts equal field sets,
    shapes, finite gradients and the losses within 1e-5 relative."""
    jloss, jgrads = grads["jax"]
    loss, tgrads = grads["port"]
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert set(tgrads) == set(train.DIFFERENTIABLE_FIELDS) == set(jgrads)
    bad = {}
    for f in train.DIFFERENTIABLE_FIELDS:
        g, r = tgrads[f], jgrads[f]
        assert g.shape == r.shape and np.isfinite(g).all(), f
        if l2rel(g, r) > tol.get(f, tol["*"]):
            bad[f] = l2rel(g, r)
    return bad


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


def texture_lanes(tex, n=20_000, seed=3):
    """Seeded per-lane texture inputs (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)
    over the atlas arrays ``tex``."""
    rng = np.random.default_rng(seed)
    k = tex[1].shape[0]
    tex_id = rng.integers(0, k, n).astype(np.int32)
    st = rng.uniform(-1.0, 2.0, (2, n)).astype(np.float32)
    # derivative magnitudes from 1e-6 to 10 texture widths: below level 0, every
    # level, and past the top (the 1x1 mip)
    der = (10.0 ** rng.uniform(-6, 1, (4, n)) * rng.choice([-1.0, 1.0], (4, n)))
    return (tex_id, st[0], st[1], *der.astype(np.float32))
