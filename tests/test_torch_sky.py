"""K5: the port's sky sampling against the JAX package's sample_sky."""

import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.ops.sky_sample import sample_sky as jax_sample_sky
from raytracer_tpu.scene import sky as jax_sky
from raytracer_tpu_torch.ops import sky_sample


def test_sky_matches_jax():
    data, size = jax_sky.procedural_probe(256)
    data = data.astype(np.float32)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(65_536, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = np.asarray(jax_sample_sky(jnp.asarray(data), jnp.int32(size), jnp.asarray(d)))
    out = sky_sample.sample_sky(torch.from_numpy(data), torch.from_numpy(d)).numpy()
    # Texel values are equal.  acos differs by an ulp between XLA and torch, which
    # can move u*size+0.5 across an integer: at most 1e-3 of the lanes may take a
    # neighbouring texel.
    other = np.any(out != ref, axis=1)
    assert other.mean() <= 1e-3, other.mean()
