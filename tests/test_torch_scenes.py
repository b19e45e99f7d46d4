"""Configs 0, 2 and 4 through the port's renderer against the JAX package's
render_with_stats (lossless profile), fed the same packed frames; config4 on two
animated frames, ``render_frames`` against per-frame renders, the heatmap, and
FXAA ``present`` on a rendered frame."""

import numpy as np
import pytest
import torch

from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu_torch.render import renderer
from torch_parity import jax_frames, jax_scene, jit, torch_config, torch_scene

# (scene, width, height, animation steps of the frames, config changes); config2
# at 4 bounces is the golden test's own cut (tests/test_golden.py)
CASES = {
    "config0": ("config0", 32, 32, (0,), {}),
    "config2": ("config2", 32, 32, (0,), {"num_bounces": 4}),
    "config4": ("config4", 48, 32, (0, 2), {}),
}
# mean abs bound per scene (measured: config0 4.0e-8, config4 1.2e-7 and 7.0e-8);
# every scene also holds >= 99.5% of pixels within 1e-3.  config2 is looser: on
# its checker plane 4 of 1,024 pixels (u = +-1.8, |ds_dx| == |ds_dy|) sit on the
# filter's x/y-major tie, which the primary directions' one-ulp difference
# (XLA:CPU fuses multiply-adds, ROADMAP C1) breaks the other way; those pixels
# move by up to 0.18 and the mean to 6.3e-4 (measured)
MEAN_ABS = {"config0": 1e-5, "config2": 1e-3, "config4": 1e-5}


def _stats(stats) -> dict:
    return {k: int(v) for k, v in stats._asdict().items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def rendered(request):
    """(name, [(JAX image, JAX stats, port image, port stats, port scene)]) per frame."""
    name, w, h, updates, changes = CASES[request.param]
    frames, cfg = jax_frames(name, w, h, updates, **changes)
    fn = jit(lambda s: jax_renderer.render_with_stats(s, cfg))
    out = []
    for scene in frames:
        jimg, jstats = fn(scene)
        tscene = torch_scene(scene)
        with torch.no_grad():
            img, stats = renderer.render_with_stats(tscene, torch_config(cfg))
        out.append((np.asarray(jimg), _stats(jstats), img.numpy(), _stats(stats), tscene))
    return request.param, out, torch_config(cfg)


def test_scene_matches_jax(rendered):
    name, frames, _cfg = rendered
    for jimg, jstats, img, stats, _ in frames:
        assert stats == jstats, (stats, jstats)
        assert stats["num_dropped"] == 0 and stats["num_incomplete"] == 0
        assert img.shape == jimg.shape and np.isfinite(img).all()
        diff = np.abs(img - jimg)
        assert diff.mean() <= MEAN_ABS[name], diff.mean()
        assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.995
    if name == "config4":  # the animation moved the instances between the frames
        assert np.abs(frames[0][2] - frames[1][2]).max() > 0.01


def test_render_frames_is_per_frame_renders(rendered):
    """render_frames of the frames: images [N,H,W,3] and counters [N], equal to
    each frame rendered alone."""
    name, frames, cfg = rendered
    with torch.no_grad():
        imgs, stats = renderer.render_frames([f[4] for f in frames], cfg)
    assert imgs.shape == (len(frames), cfg.height, cfg.width, 3)
    for k, (_, _, img, st, _) in enumerate(frames):
        assert torch.equal(imgs[k], torch.from_numpy(img))
        assert {f: int(v[k]) for f, v in stats._asdict().items()} == st
    assert all(v.shape == (len(frames),) for v in stats)


def test_heatmap_matches_jax():
    """visualize_heatmap on config1: K1's step counts scaled by (1/32, 1/256, 1/512),
    primary rays only."""
    scene, cfg = jax_scene("config1")
    cfg = cfg.replace(visualize_heatmap=True)
    jimg, jstats = jit(lambda s: jax_renderer.render_with_stats(s, cfg))(scene)
    with torch.no_grad():
        img, stats = renderer.render_with_stats(torch_scene(scene), torch_config(cfg))
    assert _stats(stats) == _stats(jstats)
    assert _stats(stats)["num_shadow"] == 0
    # steps are integers: the heat is exact where the walks agree (ROADMAP C1
    # allows a tie on <= 0.1% of lanes, none on config1)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    assert float(img.max()) > 0


def test_present_fxaa_matches_jax():
    """FXAA present of a rendered config1 frame (the port's render) against JAX
    present (K8 plain path): within 1e-5 abs on >= 99.9% of pixels, mean <= 1e-6."""
    scene, cfg = jax_scene("config1")
    cfg = cfg.replace(enable_fxaa=True)
    with torch.no_grad():
        img, _ = renderer.render_with_stats(torch_scene(scene), torch_config(cfg))
    ref = np.asarray(jit(lambda x: jax_renderer.present(x, cfg))(img.numpy()))
    got = renderer.present(img, torch_config(cfg)).numpy()
    d = np.abs(got - ref).max(axis=-1)
    assert (d <= 1e-5).mean() >= 0.999 and d.mean() <= 1e-6, (d.max(), d.mean())
