"""K3: the port's MIPMAP + ANISOTROPIC texture sample against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import texture_sample as jax_texture
from raytracer_tpu_torch.config import MipmapFilter, TextureSampleMode
from raytracer_tpu_torch.ops import texture_sample
from torch_parity import fields, jax_scene, torch_config

TEX_FIELDS = ("tex_data", "tex_width", "tex_height", "tex_levels", "tex_offsets", "tex_quad")


@pytest.fixture(scope="module")
def atlas():
    scene, cfg = jax_scene("config3")
    f = fields(scene)
    return tuple(f[k] for k in TEX_FIELDS), cfg


def _lanes(tex, n=20_000, seed=3):
    rng = np.random.default_rng(seed)
    k = tex[1].shape[0]
    tex_id = rng.integers(0, k, n).astype(np.int32)
    st = rng.uniform(-1.0, 2.0, (2, n)).astype(np.float32)
    # derivative magnitudes from 1e-6 to 10 texture widths: below level 0, every
    # level, and past the top (the 1x1 mip)
    der = (10.0 ** rng.uniform(-6, 1, (4, n)) * rng.choice([-1.0, 1.0], (4, n)))
    return (tex_id, st[0], st[1], *der.astype(np.float32))


def test_texture_matches_jax(atlas):
    tex, cfg = atlas
    lanes = _lanes(tex)
    jtex = tuple(jnp.asarray(a) for a in tex)
    ref = np.asarray(jax_texture.sample(
        jtex, *(jnp.asarray(a) for a in lanes), cfg, data4=jax_texture.expand_quads(jtex)))
    ttex = tuple(torch.from_numpy(a) for a in tex)
    out = texture_sample.sample(
        ttex, *(torch.from_numpy(a) for a in lanes), torch_config(cfg),
        data4=texture_sample.expand_quads(ttex)).numpy()
    # log2 differs by an ulp between XLA and torch, which flips round-half
    # level choices: max abs <= 1e-5 on >= 99.9% of lanes
    err = np.abs(out - ref).max(axis=1)
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    # the level-0 (level < 0), mip and top cases are all exercised
    lf = tex[3][lanes[0]]
    assert (lf > 1).any() and (lf == 1).any()


@pytest.mark.parametrize("change", [
    dict(texture_sample_mode=TextureSampleMode.NEAREST),
    dict(texture_sample_mode=TextureSampleMode.BILINEAR),
    dict(mipmap_filter=MipmapFilter.TRILINEAR),
    dict(mipmap_filter=MipmapFilter.EWA),
])
def test_modes_not_ported_raise(atlas, change):
    tex, cfg = atlas
    lanes = [torch.from_numpy(a) for a in _lanes(tex, n=16)]
    ttex = tuple(torch.from_numpy(a) for a in tex)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        texture_sample.sample(ttex, *lanes, torch_config(cfg).replace(**change),
                              data4=texture_sample.expand_quads(ttex))
