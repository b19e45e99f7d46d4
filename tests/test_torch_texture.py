"""K3: the port's texture sample in every mode against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import texture_sample as jax_texture
from raytracer_tpu_torch.config import MipmapFilter, TextureSampleMode
from raytracer_tpu_torch.ops import texture_sample
from torch_parity import fields, jax_scene, texture_lanes, torch_config

TEX_FIELDS = ("tex_data", "tex_width", "tex_height", "tex_levels", "tex_offsets", "tex_quad")


@pytest.fixture(scope="module")
def atlas():
    scene, cfg = jax_scene("config3")
    f = fields(scene)
    return tuple(f[k] for k in TEX_FIELDS), cfg


def test_texture_matches_jax(atlas):
    tex, cfg = atlas
    lanes = texture_lanes(tex)
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


MODES = {
    "nearest": dict(texture_sample_mode=TextureSampleMode.NEAREST),
    "bilinear": dict(texture_sample_mode=TextureSampleMode.BILINEAR),
    "trilinear": dict(mipmap_filter=MipmapFilter.TRILINEAR),
    "ewa": dict(mipmap_filter=MipmapFilter.EWA),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_texture_mode_matches_jax(atlas, mode):
    """NEAREST, BILINEAR, TRILINEAR and EWA (the full 16 x 16 window) against eager
    jax_texture.sample on 4,096 seeded lanes: max abs <= 1e-5 on >= 99.9% of
    lanes (measured: every lane, at most 2.4e-7), and every branch of the mode
    is taken."""
    tex, cfg = atlas
    cfg = cfg.replace(**MODES[mode])
    assert cfg.ewa_max_span == 16
    lanes = texture_lanes(tex, n=4096)
    jtex = tuple(jnp.asarray(a) for a in tex)
    ref = np.asarray(jax_texture.sample(jtex, *(jnp.asarray(a) for a in lanes), cfg))
    ttex = tuple(torch.from_numpy(a) for a in tex)
    tlanes = tuple(torch.from_numpy(a) for a in lanes)
    tcfg = torch_config(cfg)
    out = texture_sample.sample(ttex, *tlanes, tcfg).numpy()
    err = np.abs(out - ref).max(axis=1)
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    # on the mipmapped lanes: the level-0 tap (level < 0, or EWA's degenerate
    # ellipses), the top texel and the filter itself (EWA's window) all occur
    mip = torch.from_numpy(tex[3][lanes[0]] > 1)
    work = texture_sample.lane_work(ttex, tuple(x[mip] for x in tlanes), tcfg)
    if mode in ("trilinear", "ewa"):
        assert min(work["bilinear"], work["top"], work["filter"]) > 0, work
    else:
        assert work["filter"] == int(mip.sum())
    if mode == "ewa":
        assert 0 < work["weighted"] < work["taps"], work
