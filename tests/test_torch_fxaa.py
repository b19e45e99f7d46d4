"""K8 FXAA: the port's plain path against raytracer_tpu.ops.fxaa.fxaa on seeded
images: odd sizes, a single row, hard edges, values outside [0, 1] and the
clamp-to-edge borders."""

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import fxaa as jax_fxaa
from raytracer_tpu_torch.ops import fxaa

# Measured: at most 2.5e-6 abs, mean 4.4e-8 (pow and the luma dot round
# differently under XLA:CPU, ROADMAP C1).  A one-ulp luma difference can move a
# tap across a floor or flip the 2-vs-4 choice on rare pixels, hence the share.
TOL, SHARE, MEAN = 1e-5, 0.999, 1e-6


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.2, 1.4, (h, w, 3)).astype(np.float32)
    img[:, w // 2:] *= 0.05  # a hard vertical edge
    img[h // 2:, :, 1] = 0.0  # a hard horizontal edge in green
    return img


@pytest.mark.parametrize("h,w", [(37, 53), (1, 7), (7, 1), (64, 48)])
def test_fxaa_matches_jax(h, w):
    img = _image(h, w, h * 100 + w)
    ref = np.asarray(jax.jit(jax_fxaa.fxaa)(img))
    got = fxaa.fxaa(torch.from_numpy(img)).numpy()
    assert got.shape == ref.shape == (h, w, 3)
    d = np.abs(got - ref).max(axis=-1)
    assert (d <= TOL).mean() >= SHARE and d.mean() <= MEAN, (d.max(), d.mean())


def test_fxaa_blurs_an_edge_and_keeps_flat_regions():
    """A flat image passes through as its gamma; a hard edge is softened."""
    flat = torch.full((9, 11, 3), 0.25)
    np.testing.assert_allclose(fxaa.fxaa(flat).numpy(), 0.25 ** (1 / 2.2), rtol=1e-6)
    edge = torch.zeros((16, 16, 3))
    edge[:, 8:] = 1.0
    edge[8:, :] = 1.0  # an L-shaped edge: the diagonal gradient is nonzero
    out = fxaa.fxaa(edge).numpy()
    assert ((out > 0.01) & (out < 0.99)).any()
