"""K6: the port's stable compaction against the JAX package's compact_indices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.compaction import compact_indices
from raytracer_tpu_torch.ops import compaction, sky_sample, texture_sample


@pytest.mark.parametrize("n,density", [
    (1, 0.5), (1000, 0.3), (4096, 0.0), (4096, 1.0), (100_003, 0.05), (65_536, 0.6),
])
def test_compact_matches_jax(n, density):
    flags = np.random.default_rng(n).random(n) < density
    n_active = int(flags.sum())
    ref = np.asarray(compact_indices(jnp.asarray(flags), n))[:n_active]
    idx, count = compaction.compact(torch.from_numpy(flags))
    assert count == n_active
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref)


def test_cpu_tensors_take_the_plain_versions():
    """A wrapper given CPU tensors runs its plain version and launches nothing."""
    before = (compaction.launches, sky_sample.launches, texture_sample.launches)
    flags = torch.tensor([True, False, True])
    assert compaction.compact(flags)[1] == compaction.compact_plain(flags)[1]
    sky = torch.rand(16, 3)
    d = torch.nn.functional.normalize(torch.randn(8, 3), dim=1)
    assert torch.equal(sky_sample.sample_sky(sky, d), sky_sample.sample_sky_plain(sky, d))
    assert (compaction.launches, sky_sample.launches, texture_sample.launches) == before
