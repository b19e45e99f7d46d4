"""config3-tiny rendered under every texture mode the JAX package has besides its
default: the port's render against JAX's under NEAREST, BILINEAR, TRILINEAR and
EWA, the 17 gradients under TRILINEAR, and NEAREST's render without a quad atlas.

One bounce keeps the JAX programs small (the tier-1 clock is nearly full); EWA
runs here with a 4 x 4 window (``ewa_max_span=4``), so that its unrolled scan
compiles quickly.  The full 16 x 16 window is held against JAX at op level
(tests/test_torch_texture.py, tests/test_torch_grad.py) and on the card at 1080p
(chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from raytracer_tpu.config import MipmapFilter, TextureSampleMode
from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu_torch.ops import texture_sample
from raytracer_tpu_torch.render import renderer
from torch_parity import (grad_mismatches, jax_scene, jit, masked_grads, stat_dict,
                          torch_config, torch_scene)

MODES = {
    "nearest": dict(texture_sample_mode=TextureSampleMode.NEAREST),
    "bilinear": dict(texture_sample_mode=TextureSampleMode.BILINEAR),
    "trilinear": dict(mipmap_filter=MipmapFilter.TRILINEAR),
    "ewa": dict(mipmap_filter=MipmapFilter.EWA, ewa_max_span=4),
}


def _scene(mode):
    scene, cfg = jax_scene("config3")
    return scene, cfg.replace(num_bounces=1, **MODES[mode])


# share of pixels within 1e-3.  config3-tiny's default render allows 99.5%
# (tests/test_torch_render.py): one primary lane takes the neighbouring triangle
# across a shared edge (ROADMAP C1).  NEAREST rounds u * width to a texel, and one
# pixel column of this view lies on a texel edge (u * 256 = 215.5 +- 0.0015),
# where the hit's u, up to 7e-6 apart between XLA:CPU's fused multiply-adds and
# the port (C1), rounds to the other texel: 14 more pixels (measured 99.35%).
WITHIN_1E3 = {"nearest": 0.99}


@pytest.fixture(scope="module")
def trilinear():
    """masked_grads under TRILINEAR: its gradients, and the two forward renders
    that the TRILINEAR render test shares (one JAX program for both tests)."""
    return masked_grads(*_scene("trilinear"), seed=21)


@pytest.mark.parametrize("mode", list(MODES))
def test_filter_render_matches_jax(mode, request):
    """Counters equal; mean abs <= 5e-4 and the share of pixels within 1e-3
    stated above.  TRILINEAR's JAX image is the forward of its gradient program."""
    if mode == "trilinear":
        ref_img, ref_stats, img, stats = request.getfixturevalue("trilinear")["forward"]
    else:
        scene, cfg = _scene(mode)
        ref_img, ref_stats = jit(lambda s: jax_renderer.render_with_stats(s, cfg))(scene)
        with torch.no_grad():
            img, stats = renderer.render_with_stats(torch_scene(scene), torch_config(cfg))
        ref_stats, stats = stat_dict(ref_stats), stat_dict(stats)
        img, ref_img = img.numpy(), np.asarray(ref_img)
    assert stats == ref_stats, (stats, ref_stats)
    assert stats["num_dropped"] == 0 and stats["num_incomplete"] == 0
    assert img.shape == ref_img.shape and np.isfinite(img).all()
    diff = np.abs(img - ref_img)
    assert diff.mean() <= 5e-4, diff.mean()
    assert (diff.max(axis=-1) <= 1e-3).mean() >= WITHIN_1E3.get(mode, 0.995)


def test_trilinear_render_grads_match_jax(trilinear):
    """The 17 gradients of the masked loss under TRILINEAR, the only filter whose
    gradient also runs through the derivatives to the camera: every field,
    tex_data and the camera's among them, within 1e-4 l2-relative (measured:
    tex_data 1.5e-6, the camera fields 2.4e-5 to 4.5e-5, the rest <= 6.4e-6;
    1 pixel masked by the forward's C1 tie), and the camera fields reached."""
    grads = trilinear
    assert grads["n_masked"] <= 4, grads["n_masked"]
    bad = grad_mismatches(grads, {"*": 1e-4})
    assert not bad, bad
    tgrads = grads["port"][1]
    for f in ("cam_pos", "cam_top_left", "cam_x", "cam_y", "tex_data"):
        assert np.abs(tgrads[f]).sum() > 0, f


def test_nearest_render_builds_no_quad_atlas(monkeypatch):
    """NEAREST reads the base atlas only: a NEAREST render never expands the quad
    atlas, as the JAX renderer skips it; a BILINEAR render does."""
    scene, cfg = _scene("nearest")
    tscene = torch_scene(scene)
    calls, expand = [], texture_sample.expand_quads
    monkeypatch.setattr(texture_sample, "expand_quads",
                        lambda tex: calls.append(1) or expand(tex))
    with torch.no_grad():
        img, _ = renderer.render_with_stats(tscene, torch_config(cfg))
        assert torch.isfinite(img).all() and not calls
        renderer.render_with_stats(tscene, torch_config(_scene("bilinear")[1]))
    assert calls
