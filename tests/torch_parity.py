"""Shared set-up of the parity tests between raytracer_tpu (JAX) and raytracer_tpu_torch.

Both packages get identical inputs: scenes come from the JAX ``ScenePacker`` and
reach the port through ``scene_from_numpy``; rays and other inputs are numpy
arrays made from a seed.  The JAX side runs on the CPU (tests/conftest.py) under
its lossless profile with one chunk, which is the port's semantics.
"""

import atexit
import contextlib
import enum
import functools
import os
import shutil
import tempfile
import time

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


_CACHE_DIR = None


def _run_cache_dir() -> str:
    """This process's BLAS cache directory: made fresh under ``.cache/`` on
    first use and removed at exit, so no later run reads what this one wrote."""
    global _CACHE_DIR
    if _CACHE_DIR is None:
        os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
        _CACHE_DIR = tempfile.mkdtemp(prefix="torch_parity_", dir=os.path.join(REPO, ".cache"))
        atexit.register(shutil.rmtree, _CACHE_DIR, True)
    return _CACHE_DIR


def same_builder() -> bool:
    """Make both packages run the same SBVH builder and return whether it is
    the native one.

    The JAX package compiles its library with no lock; a process that opens it
    while another writes it falls back to the numpy object-split builder for
    the rest of its life (``raytracer_tpu/accel/native.py:_load``).  Under the
    port's build lock (held on the JAX library's own lock file) this loads the
    JAX side's library; if a race left its failure flag set while g++ is on
    ``PATH``, it clears the flag and the JAX package's BLAS memory cache and
    tries again, then asserts that both sides agree on native or numpy."""
    from raytracer_tpu.accel import blas as jax_blas
    from raytracer_tpu.accel import native as jax_native
    from raytracer_tpu_torch.accel import native as port_native

    port = port_native.available()
    with port_native.build_lock(jax_native._SO):
        ok = jax_native.available()
        for _ in range(20):
            if ok or shutil.which("g++") is None:
                break
            time.sleep(0.5)  # another process may be writing the file
            jax_native._lib_failed = False
            jax_blas.clear_cache()
            ok = jax_native.available()
    assert ok == port, f"SBVH builders differ: JAX native={ok}, port native={port}"
    return port


@contextlib.contextmanager
def private_bvh_cache():
    """Build scenes with both packages on the same SBVH builder and with this
    process's own BLAS disk cache.  Both packages cache BLASes under a path
    relative to the working directory, written without a lock, and test workers
    that build the same mesh at once would write the same file; a directory
    made fresh for this process (gitignored) keeps them apart."""
    same_builder()
    d = _run_cache_dir()
    old = os.getcwd()
    os.chdir(d)
    try:
        yield
    finally:
        os.chdir(old)


@functools.lru_cache(maxsize=None)
def jax_scene(name: str):
    """(JAX DeviceScene, lossless JAX RenderConfig) of a test-size scene; packed
    once per process (the arrays are immutable), as several files use each."""
    with private_bvh_cache():
        return _jax_scene(name)


@functools.lru_cache(maxsize=None)
def jax_render(name: str):
    """(image numpy [H,W,3], counters) of JAX's render of ``jax_scene(name)``;
    rendered once per process."""
    scene, cfg = jax_scene(name)
    img, stats = jit(lambda s: jax_renderer.render_with_stats(s, cfg))(scene)
    return np.asarray(img), stat_dict(stats)


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


@functools.lru_cache(maxsize=None)
def jax_frames(name: str, width: int, height: int, updates=(0,), **changes):
    """((JAX DeviceScene of the frame after k animation steps of 1/60 s, for k in
    ``updates``), lossless JAX RenderConfig) of ``make_scene(name)`` at
    width x height, with ``changes`` to its config; packed once per process."""
    with private_bvh_cache():
        desc, cfg = jax_scenes.make_scene(name)
        packer = JaxPacker(desc, width, height)
        frames, done = [], 0
        for k in updates:
            while done < k:
                desc.update(1.0 / 60.0)
                done += 1
            frames.append(packer.frame())
    return tuple(frames), _lossless(cfg, width, height, **changes)


def seeded_target(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (cfg.height, cfg.width, 3)).astype(np.float32)


def stat_dict(stats) -> dict:
    return {k: int(v) for k, v in stats._asdict().items()}


def masked_grads(scene, cfg, seed=21) -> dict:
    """JAX and port (loss, {field: grad}) of the mean squared error against a
    seeded target, over the 17 differentiable fields of a JAX DeviceScene, with
    the loss masked to the pixels whose forward images agree within 1e-3
    (ROADMAP C1); ``n_masked`` counts the pixels left out.  ``forward`` holds
    both forward renders, (JAX image, JAX counters, port image, port counters):
    a forward test of the same config can share them."""
    target = seeded_target(cfg, seed)
    params = jax_train.extract_params(scene)

    def masked_loss(p, mask):
        img, stats = jax_renderer.render_with_stats(jax_train.apply_params(scene, p), cfg)
        se = jnp.where(mask[..., None], (img - target) ** 2, 0.0)
        return jnp.sum(se) / (jnp.sum(mask) * 3), (img, stats)

    # one program; the first run (nothing masked) gives the forward image
    vg = jax.jit(jax.value_and_grad(masked_loss, has_aux=True))
    all_px = np.ones((cfg.height, cfg.width), bool)
    (_, (jimg, jstats)), _ = vg(params, all_px)

    tscene, tcfg = torch_scene(scene), torch_config(cfg)
    with torch.no_grad():
        timg, tstats = renderer.render_with_stats(tscene, tcfg)
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
        forward=(np.asarray(jimg), stat_dict(jstats), timg.numpy(), stat_dict(tstats)),
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
    """The port's copy of a JAX RenderConfig, knob for knob; enum knobs become
    the port's own enum members of the same name."""
    ours = TorchConfig()

    def knob(f):
        v = getattr(cfg, f)
        return type(getattr(ours, f))[v.name] if isinstance(v, enum.Enum) else v

    return TorchConfig(**{f: knob(f) for f in cfg.__dataclass_fields__})


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
