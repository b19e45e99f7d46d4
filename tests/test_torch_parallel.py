"""Pixel sharding over ``torch.distributed`` (``raytracer_tpu_torch/parallel``):
two gloo ranks on the CPU render config1 strided over a (2, 1) mesh and take a
sharded train step; the results must equal the port's single-process ones and
stay within the JAX render's parity bound.

The ranks are spawned once for the file (``pixel_group``), each group with a
``FileStore`` under its own ``tmp_path`` and a time limit of its own, and write
what they computed for the tests to read.  JAX results come from the memoised
helpers of ``torch_parity`` (imported inside the tests, so that the spawned
ranks, which import this module, do not import JAX).
"""

import os
import pickle
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.parallel import mesh as pmesh

GROUP_TIMEOUT_S = 120


# ------------------------------------------------------------ spawned groups


def _rank_main(target, rank, world, store, out):
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    try:
        with open(os.path.join(out, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        distributed.initialize(init_method="file://" + store, world_size=world, rank=rank,
                               device="cpu")
        result = target(rank, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_group(target, world, out_dir, *args, timeout=GROUP_TIMEOUT_S, meanwhile=None):
    """Run ``target(rank, *args)`` in ``world`` spawned gloo ranks joined by a
    FileStore in ``out_dir``; returns each rank's result.  ``meanwhile()``, if
    given, runs in this process while the ranks work.  A group that has not
    finished within ``timeout`` seconds is killed and fails the caller."""
    ctx = mp.get_context("spawn")
    out_dir = str(out_dir)
    store = os.path.join(out_dir, "store")
    # the arguments go through a file: a large argument of Process would block
    # start() until the child has imported its modules, so the ranks would
    # start one after another
    with open(os.path.join(out_dir, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, store, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            p.join(timeout)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    errors = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
              if f.endswith(".err")]
    assert not hung, f"{len(hung)} rank(s) still running after {timeout} s"
    assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def stat_dict(stats) -> dict:
    return {k: int(v) for k, v in stats._asdict().items()}


# ------------------------------------------------------------ the pixel ranks


def seeded_target(cfg, seed=21):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (cfg.height, cfg.width, 3)).astype(np.float32)


def _pixel_rank(rank, fields, cfg_fields):
    from raytracer_tpu_torch.diff import train
    from raytracer_tpu_torch.parallel import collectives, scaling, shard
    from raytracer_tpu_torch.render import renderer
    from raytracer_tpu_torch.scene.tensors import scene_from_numpy

    cfg = RenderConfig(**cfg_fields)
    scene = scene_from_numpy(fields, device="cpu")
    mesh = pmesh.make_mesh((2, 1), device_type="cpu")
    out = {}

    # the sharded frame, and the same frame rendered whole on this rank
    collectives.reset()
    img, stats = shard.make_sharded_renderer(cfg, mesh)(scene)
    out["counts_frame"] = dict(collectives.counts)
    out["image"], out["stats"] = img.numpy(), stat_dict(stats)
    with torch.no_grad():
        single, sstats = renderer.render_with_stats(scene, cfg)
    out["single_image"], out["single_stats"] = single.numpy(), stat_dict(sstats)

    # an odd pixel count: one padded slot on rank 1 (the camera stays as packed)
    odd = cfg.replace(width=cfg.width + 1, height=cfg.height - 1)
    img, stats = shard.make_sharded_renderer(odd, mesh)(scene)
    with torch.no_grad():
        single, sstats = renderer.render_with_stats(scene, odd)
    out["odd"] = (img.numpy(), stat_dict(stats), single.numpy(), stat_dict(sstats))

    # one sharded train step against make_train_step's on the whole frame
    target = torch.from_numpy(seeded_target(cfg))
    init, step = train.make_sharded_train_step(cfg, mesh)
    params, opt = init(scene)
    collectives.reset()
    _, _, loss = step(params, opt, scene, target)
    out["counts_step"] = dict(collectives.counts)
    out["step"] = (float(loss), {k: p.grad.numpy().copy() for k, p in params.items()})
    init1, step1 = train.make_train_step(cfg)
    params1, opt1 = init1(scene)
    _, _, loss1 = step1(params1, opt1, scene, target)
    out["single_step"] = (float(loss1), {
        k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
        for k, p in params1.items()})

    out["scaling"] = scaling.measure(scene, cfg, device_counts=(1, 2, 4), iters=1)

    # the port's differentiable all-gather against torch's own (deprecated) one:
    # each rank weighs every rank's slice differently, so a slice's gradient
    # is the sum of the ranks' weights for it
    import warnings

    import torch.distributed.nn.functional as dist_fn

    group = mesh.get_group("dp")
    weights = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3) * (rank + 1)
    grads = []
    for gather in (lambda x: collectives.all_gather(x, group),
                   lambda x: torch.stack(dist_fn.all_gather(x, group=group))):
        x = torch.full((2, 3), float(rank + 1), requires_grad=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            (gather(x) * weights).sum().backward()
        grads.append(x.grad.numpy().copy())
    out["gather_grads"] = grads
    return out


@pytest.fixture(scope="module")
def pixel_group(tmp_path_factory):
    """(config1's JAX scene and config, both ranks' results); JAX's render of
    the scene (memoised) is made while the ranks work."""
    from torch_parity import fields, jax_render, jax_scene, torch_config

    scene, cfg = jax_scene("config1")
    tcfg = torch_config(cfg)
    ranks = spawn_group(_pixel_rank, 2, tmp_path_factory.mktemp("pixel_group"), fields(scene),
                        {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__},
                        meanwhile=lambda: jax_render("config1"))
    return scene, cfg, ranks


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("num_pixels,num_shards", [(1024, 2), (1024, 8), (1023, 2), (97, 8)])
def test_permutation_matches_jax(num_pixels, num_shards):
    from raytracer_tpu.parallel.mesh import strided_pixel_permutation as jax_perm

    ours = pmesh.strided_pixel_permutation(num_pixels, num_shards)
    ref = jax_perm(num_pixels, num_shards)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    slots, inverse = pmesh.shard_slots(num_pixels, num_shards)
    flat = slots.reshape(-1)
    # every pixel once, padded slots -1, the rest as JAX assigns them
    assert np.array_equal(np.sort(flat[flat >= 0]), np.arange(num_pixels))
    assert np.array_equal(flat[flat >= 0], ref[flat >= 0])
    assert np.array_equal(flat[inverse], np.arange(num_pixels))


def test_sharded_image_equals_single_render(pixel_group):
    """Tolerance 0: a pixel's arithmetic does not depend on its batch."""
    _, _, ranks = pixel_group
    for r in ranks:
        assert np.array_equal(r["image"], r["single_image"])
    assert np.array_equal(ranks[0]["image"], ranks[1]["image"])


def test_sharded_image_within_jax_parity_bound(pixel_group):
    """The bound of ``test_torch_render.py::test_render_matches_jax[config1]``."""
    from test_torch_render import MEAN_ABS
    from torch_parity import jax_render

    scene, cfg, ranks = pixel_group
    ref_img, ref_stats = jax_render("config1")
    diff = np.abs(ranks[0]["image"] - ref_img)
    assert diff.mean() <= MEAN_ABS["config1"], diff.mean()
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.995
    for k in ("num_primary", "num_shadow", "num_reflection", "num_refraction"):
        assert ranks[0]["stats"][k] == ref_stats[k], k


def test_sharded_counters_equal_single_render(pixel_group):
    _, cfg, ranks = pixel_group
    for r in ranks:
        assert r["stats"] == r["single_stats"]
    assert ranks[0]["stats"]["num_primary"] == cfg.width * cfg.height
    assert ranks[0]["stats"]["num_dropped"] == ranks[0]["stats"]["num_incomplete"] == 0


def test_odd_pixel_count(pixel_group):
    _, cfg, ranks = pixel_group
    img, stats, single, sstats = ranks[0]["odd"]
    assert (cfg.width + 1) * (cfg.height - 1) % 2 == 1
    assert img.shape == single.shape and np.array_equal(img, single)
    assert stats == sstats and stats["num_primary"] == img.shape[0] * img.shape[1]
    assert np.array_equal(ranks[1]["odd"][0], img)


def test_sharded_step_matches_single_step(pixel_group):
    """Loss and every gradient within 1e-5 relative of ``make_train_step``'s
    (the sums run over the pixels in another order)."""
    from torch_parity import l2rel

    _, _, ranks = pixel_group
    for r in ranks:
        loss, grads = r["step"]
        loss1, grads1 = r["single_step"]
        assert abs(loss - loss1) <= 1e-5 * abs(loss1), (loss, loss1)
        assert set(grads) == set(grads1)
        for k, g in grads.items():
            assert np.isfinite(g).all(), k
            assert l2rel(g, grads1[k]) <= 1e-5 if np.any(grads1[k]) else not np.any(g), k
    # both ranks hold the same reduced gradients
    for k, g in ranks[0]["step"][1].items():
        assert np.array_equal(g, ranks[1]["step"][1][k]), k


def test_dp_collectives(pixel_group):
    """The sharded frame communicates one image gather and one counter
    all-reduce; the sharded step one all-reduce of the loss and every gradient
    and no gather (``tests/test_collectives.py`` checks the same of JAX)."""
    _, _, ranks = pixel_group
    for r in ranks:
        assert r["counts_frame"] == {"all_gather": 1, "all_reduce": 1, "reduce_scatter": 0}
        assert r["counts_step"] == {"all_gather": 0, "all_reduce": 1, "reduce_scatter": 0}


def test_mesh_axes_are_scoped_to_the_call():
    """``collectives.group`` answers from the innermost active ``mesh_axes``
    block, restores the outer mesh on leaving it, and raises outside any, so
    building a second mesh with the same axis names moves no one's group."""
    from raytracer_tpu_torch.parallel import collectives

    class Mesh:
        mesh_dim_names = ("dp", "sp")

        def __init__(self, tag):
            self.tag = tag

        def get_group(self, name):
            return self.tag, name

    with pytest.raises(RuntimeError, match="outside a mesh"):
        collectives.group("sp")
    with collectives.mesh_axes(Mesh("a")):
        assert collectives.group("sp") == ("a", "sp")
        with collectives.mesh_axes(Mesh("b")):
            assert collectives.group("sp") == ("b", "sp")
        assert collectives.group("dp") == ("a", "dp")
        with pytest.raises(KeyError, match="no axis 'tp'"):
            collectives.group("tp")
    with pytest.raises(RuntimeError, match="outside a mesh"):
        collectives.group("sp")


def test_scaling_measures_each_count_the_group_offers(pixel_group):
    _, _, ranks = pixel_group
    rep = ranks[0]["scaling"]
    assert sorted(rep["rays_per_s"]) == [1, 2]  # 4 > the group's 2 ranks: skipped
    assert all(v > 0 for v in rep["rays_per_s"].values())
    assert rep["efficiency"][1] == pytest.approx(1.0)


def test_initialize_reads_torchrun_variables_or_stays_single(monkeypatch):
    """No torchrun variables and no arguments: one process, rank 0, no group.
    ``nccl`` without CUDA raises instead of switching to gloo."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel import distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") == 0
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", "29500")
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="nccl needs a CUDA device"):
            distributed.initialize(backend="nccl", device="cpu")
        assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.make_mesh((1, 1), device_type="cpu")


def test_all_gather_backward_sums_like_torch(pixel_group):
    """``collectives.all_gather``'s backward (one reduce-scatter) is
    torch.distributed's: each rank's slice gets the sum over the ranks of
    their cotangents for it."""
    _, _, ranks = pixel_group
    for rank, r in enumerate(ranks):
        ours, torchs = r["gather_grads"]
        expect = sum(np.arange(12, dtype=np.float32).reshape(2, 2, 3)[rank] * (k + 1)
                     for k in range(2))
        assert np.array_equal(ours, torchs) and np.array_equal(ours, expect)
