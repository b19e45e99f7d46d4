"""The port's frame loop (``raytracer_tpu_torch.app``) on the CPU: config4 with
FXAA writes the JAX app's files and per-frame JSON keys, its PNGs (written
without PIL) decode to the same pixels as the JAX package's PIL-written PNGs of
the same arrays; and the gradients of the image loss over config4-tiny's 17
fields against the JAX package's."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from raytracer_tpu.utils import image as jax_image
from raytracer_tpu.utils.stats import mrays_per_second as jax_mrays_per_second
from raytracer_tpu_torch import app
from raytracer_tpu_torch.ops import fxaa
from raytracer_tpu_torch.utils import image
from torch_parity import grad_mismatches, jax_frames, masked_grads, private_bvh_cache

_COUNTERS = ("num_primary", "num_shadow", "num_reflection", "num_refraction",
             "num_dropped")
STAT_KEYS = set(jax_mrays_per_second(types.SimpleNamespace(**dict.fromkeys(_COUNTERS, 1)),
                                     1.0))
# the JAX app's per-frame keys (raytracer_tpu/app.py), one frame at a time and batched
FRAME_KEYS = {"frame", "ms", "fps_avg", "lossless_retry"} | STAT_KEYS
BATCH_KEYS = {"frame", "ms", "batched"} | STAT_KEYS


def _pil_pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("batch", [1, 2])
def test_app_config4_fxaa(tmp_path, monkeypatch, capsys, batch):
    saved = []
    save_png = image.save_png

    def recording(path, img, gamma=True):
        saved.append((os.path.basename(path), np.array(img), gamma))
        save_png(path, img, gamma)

    monkeypatch.setattr(image, "save_png", recording)
    out = tmp_path / "out"
    argv = ["--cpu", "--scene", "config4", "--frames", "2", "--width", "48", "--height", "32",
            "--fxaa", "--out", str(out), "--batch-frames", str(batch)]
    with monkeypatch.context() as m, private_bvh_cache():
        m.setitem(sys.modules, "PIL", None)  # the frame loop needs no imaging package
        app.main(argv)

    names = ["frame_0000.png", "frame_0001.png", "final_presented.png"]
    assert sorted(os.listdir(out)) == sorted(names)
    assert [s[0] for s in saved] == names
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert [r["frame"] for r in lines] == [0, 1]
    for r in lines:
        assert set(r) == (FRAME_KEYS if batch == 1 else BATCH_KEYS), r
        assert r["dropped_rays"] == 0
        # a 48x32 frame traces exactly 1,536 primary rays: the printed rate is
        # that count over the line's own ms, to one unit of its last digit
        # (both are rounded to 2 decimals, so a slow frame may print 0.0)
        expected = round(1536 / (r["ms"] / 1e3) / 1e6, 2)
        assert abs(r["primary_mrays_s"] - expected) <= 0.01 + 1e-9, (r, expected)
        assert r["total_mrays_s"] >= r["primary_mrays_s"], r
        assert r.get("lossless_retry", False) is False
    # the animation moved the scene between the two frames
    assert np.abs(saved[0][1] - saved[1][1]).max() > 0.01
    # the presented frame is FXAA of the last frame (gamma-space, saved as is)
    np.testing.assert_array_equal(saved[2][1], fxaa.fxaa(torch.from_numpy(saved[1][1])).numpy())
    assert saved[2][2] is False
    for name, arr, gamma in saved:
        jax_image.save_png(str(tmp_path / name), arr, gamma=gamma)
        ours = _pil_pixels(out / name)
        assert ours.shape == (32, 48, 3)
        np.testing.assert_array_equal(ours, _pil_pixels(tmp_path / name))
        np.testing.assert_array_equal(image.load_png(str(out / name)), ours / np.float32(255))


@pytest.mark.parametrize("h,w", [(1, 1), (37, 53)])
def test_png_writer_matches_pil(tmp_path, h, w):
    """Linear and gamma-space images, values outside [0, 1] included, against the
    JAX package's PIL writer; load_png reads back what save_png writes."""
    arr = np.random.default_rng(h * w).uniform(-0.3, 1.3, (h, w, 3)).astype(np.float32)
    for gamma in (True, False):
        image.save_png(str(tmp_path / "ours.png"), arr, gamma=gamma)
        jax_image.save_png(str(tmp_path / "ref.png"), arr, gamma=gamma)
        ref = _pil_pixels(tmp_path / "ref.png")
        np.testing.assert_array_equal(_pil_pixels(tmp_path / "ours.png"), ref)
        np.testing.assert_array_equal(image.load_png(str(tmp_path / "ours.png")),
                                      ref / np.float32(255))


# every field within 1e-4 l2-relative (measured <= 4e-5, the camera and
# mat_transmittance largest) but mat_ior, within 1e-3 (measured 2.6e-4): its two
# nonzero entries, the spheres' IORs, come from a few pixels seen through both
# dielectric surfaces (8 at 40x30), whose terms of both signs cancel to a twelfth
# of their absolute sum (central differences), so the C1 rounding of those paths
# shows at 1e-4 of the result
GRAD_TOL = {"*": 1e-4, "mat_ior": 1e-3}


def test_config4_grads_match_jax():
    """Image-loss gradients over the 17 fields on config4 at 32x24, frame 2: the
    spheres' and the plane's hit records re-derived from K9's pick carry them."""
    frames, cfg = jax_frames("config4", 32, 24, (2,))
    grads = masked_grads(frames[0], cfg, seed=22)
    assert grads["n_masked"] == 0, grads["n_masked"]
    bad = grad_mismatches(grads, GRAD_TOL)
    assert not bad, bad
    tgrads = grads["port"][1]
    for f in ("cam_pos", "mat_diffuse", "mat_transmittance", "sky_data", "tex_data"):
        assert np.abs(tgrads[f]).sum() > 0, f
