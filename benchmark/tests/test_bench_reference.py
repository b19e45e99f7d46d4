"""The reference against the program at a tiny size on the CPU, and the control:
the reference in bfloat16 fails the comparison that the program passes."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, program
from benchmark.reference import compare
from benchmark.reference import fxaa as ref_fxaa
from benchmark.reference.render import Reference
from benchmark.yardstick.scenes import dynamic, sponza

CASES = {
    "dynamic": ("dynamic_900x600", dynamic, {"resolution": [60, 40]}),
    "sponza": ("sponza_1080p_threaded", sponza, {"resolution": [48, 27], "triangles": 20000}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def rendered(request, app_root):
    from raytracer_tpu_torch.render.renderer import Renderer, present
    from raytracer_tpu_torch.scene.device import ScenePacker

    name, mod, over = CASES[request.param]
    config = {**harness.configuration(harness.benchmark(app_root), name), **over}
    raw = mod.build(config)
    desc = program.description(raw, config["program_scene"])
    cfg = program.render_config(config)
    rend = Renderer(cfg, device="cpu")
    image, stats = rend(rend.upload(ScenePacker(desc, cfg.width, cfg.height).frame()))
    return config, raw, image, stats, present(image, cfg)


def _all_pixels(config):
    return torch.arange(config["resolution"][0] * config["resolution"][1])


def test_reference_matches_the_program(rendered):
    config, raw, image, stats, _ = rendered
    ref = Reference(raw, config, "cpu")
    want = ref.render(ref.camera(raw.camera_position, raw.camera_rotation),
                      _all_pixels(config))
    assert compare.share_off(image.reshape(-1, 3), want, 1e-3) <= 1e-3
    assert int(stats.num_dropped) == 0 and int(stats.num_incomplete) == 0


def test_control_fails(rendered):
    """The reference in bfloat16, put in the program's place, fails the mix's own
    limit."""
    config, raw, *_ = rendered
    pixels = _all_pixels(config)
    ref = Reference(raw, config, "cpu")
    low = Reference(raw, config, "cpu", dtype=torch.bfloat16)
    want = ref.render(ref.camera(raw.camera_position, raw.camera_rotation), pixels)
    got = low.render(low.camera(raw.camera_position, raw.camera_rotation), pixels)
    traffic = "app" if "dynamic" in config["scene"] else "flythrough"
    limit = harness.mix(traffic)["limits"]["pixels_off"]
    assert compare.share_off(got, want, harness.mix(traffic)["pixel_tol"]) > limit


def test_control_fails_the_animation_limit(app_root):
    """The animation's state held in float32 over a window's steps (700 frames, the
    fewest a 51 s window of the app holds) fails ``instance_err``'s limit; the
    program's float64 state, rounded to float32 once, reads at most half a unit."""
    import numpy as np

    from benchmark.loops.app import Loop

    config = harness.configuration(harness.benchmark(app_root), "dynamic_900x600")
    limit = harness.mix("app")["limits"]["instance_err"]
    loop = Loop.__new__(Loop)
    loop.scene_mod, loop.raw = dynamic, dynamic.build({**config, "sky_size": 16})
    loop.start = [i for i in loop.raw.instances], loop.raw.time
    loop.deltas = [2.5] + [harness.mix("app")["dt"]] * 700
    want = loop._world(loop._instances(len(loop.deltas)))
    low = loop._world(loop._instances(len(loop.deltas), np.float32)).astype(np.float32)
    assert compare.ulps32(low, want) > limit
    assert compare.ulps32(want.astype(np.float32), want) <= 0.5


@pytest.mark.parametrize("cell", ["dynamic_900x600.app", "sponza_1080p_threaded.flythrough"])
def test_control_run_is_not_correct(cell, app_root):
    """Through the harness: with ``control`` the control's outputs are judged in the
    program's place, and the run comes out not correct."""
    over = {k: v for k, v in CASES[cell.split("_")[0]][2].items()}
    result = harness.run(cell, 2**31 + 11, 0.5, False, device="cpu", overrides=over,
                         control=True, root=app_root)
    assert result["correct"] is False and result["control"] is True
    failed = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert "pixels_off" in failed
    if cell.startswith("dynamic"):
        assert "present_err" in failed


def test_reference_present_is_the_programs(rendered):
    """The presented frame: FXAA where the configuration asks for it (the
    reference's FXAA in bfloat16 is far off), else the plain gamma."""
    config, _, image, _, shown = rendered
    if config["fxaa"]:
        assert compare.max_abs(shown, ref_fxaa.fxaa(image)) == 0.0
        limit = harness.mix("app")["limits"]["present_err"]
        assert compare.max_abs(ref_fxaa.fxaa(image.to(torch.bfloat16)).float(), shown) > limit
    else:
        assert compare.max_abs(shown, torch.clamp(image, 0.0, 1.0) ** (1.0 / 2.2)) == 0.0
