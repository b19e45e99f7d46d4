"""K6: the port's stable compaction against the JAX package's compact_indices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.compaction import compact_indices
from raytracer_tpu_torch.ops import compaction, framebuffer, sky_sample
from raytracer_tpu_torch.utils import trace


SIZES = [(1, 0.5), (1000, 0.3), (4096, 0.0), (4096, 1.0), (100_003, 0.05), (65_536, 0.6)]


@pytest.mark.parametrize("n,density", SIZES)
def test_compact_matches_jax(n, density):
    flags = np.random.default_rng(n).random(n) < density
    n_active = int(flags.sum())
    ref = np.asarray(compact_indices(jnp.asarray(flags), n))[:n_active]
    idx, count = compaction.compact(torch.from_numpy(flags))
    assert count == n_active
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref)


@pytest.mark.parametrize("n,density", SIZES)
def test_compact_launch_matches_jax(n, density):
    """compact_launch on CPU tensors: the plain version's indices in the first
    ``count`` of [n] int32, the count as an int32 [1] tensor, nothing launched."""
    flags = np.random.default_rng(n).random(n) < density
    n_active = int(flags.sum())
    ref = np.asarray(compact_indices(jnp.asarray(flags), n))[:n_active]
    before = dict(trace.counters)
    out, count = compaction.compact_launch(torch.from_numpy(flags))
    assert trace.counters == before
    assert out.shape == (n,) and out.dtype == torch.int32
    assert count.shape == (1,) and count.dtype == torch.int32 and int(count) == n_active
    np.testing.assert_array_equal(out[:n_active].numpy(), ref)
    p_idx, p_n = compaction.compact_plain(torch.from_numpy(flags))
    assert p_n == n_active and torch.equal(out[:n_active], p_idx)


def test_cpu_tensors_take_the_plain_versions():
    """A wrapper given CPU tensors runs its plain version and launches nothing."""
    before = dict(trace.counters)
    flags = torch.tensor([True, False, True])
    assert compaction.compact(flags)[1] == compaction.compact_plain(flags)[1]
    sky = torch.rand(16, 3)
    d = torch.nn.functional.normalize(torch.randn(8, 3), dim=1)
    assert torch.equal(sky_sample.sample_sky(sky, d), sky_sample.sample_sky_plain(sky, d))
    index, cot = torch.tensor([3, 3, 0], dtype=torch.int32), torch.randn(3, 3)
    assert torch.equal(sky_sample.sample_backward(index, cot, 16),
                       sky_sample.sample_backward_plain(index, cot, 16))
    fb = torch.zeros(4, 3)
    assert framebuffer.accumulate(fb, torch.tensor([1, 1], dtype=torch.int32),
                                  torch.ones(2, 3)) is fb
    assert fb[1].tolist() == [2.0, 2.0, 2.0] and not fb[[0, 2, 3]].any()
    assert trace.counters == before


def test_scatter_microbench_runs_on_cpu():
    """``python -m raytracer_tpu_torch.microbench.scatter --cpu`` at a small
    size: every K5 bwd pattern within 1e-6 of the float64 sums, every K6 case
    exact, and the host line; device times are "not measured" here."""
    from raytracer_tpu_torch.microbench import scatter

    lines = scatter.main(["--cpu", "--n", "3000", "--reps", "1"])
    sky = [x for x in lines if x["bench"] == "sky_bwd"]
    flags = [x for x in lines if x["bench"] == "compact"]
    assert [x["name"] for x in sky] == [f"K5 bwd {p}" for p in scatter.SKY_PATTERNS]
    assert all(x["l2_rel"] <= 1e-6 and x["device_ms"] == "not measured" for x in sky)
    assert len(flags) == 2 * len(scatter.DENSITIES) and all(x["exact"] for x in flags)
    assert lines[-1]["bench"] == "host" and lines[-1]["device"] == "cpu"

