"""A run with the timed path broken underneath comes out not correct: once for each
fault a cell can have (a stale state, half the batch left out, an answer altered
where it is produced).  The run is the harness's own, on the CPU at a tiny size;
one chip, so no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness

TINY = {"dynamic_900x600.app": {"resolution": [60, 40]},
        "sponza_1080p_threaded.flythrough": {"resolution": [48, 27], "triangles": 20000}}
SEED = 2**31 + 5


def _run(cell, root):
    # a window of several frames, so that the window's last frame shows another
    # pose or animation step than set-up's first
    return harness.run(cell, SEED, 1.5, False, device="cpu", overrides=TINY[cell], root=root)


def _break_render(monkeypatch, how):
    from raytracer_tpu_torch.render import renderer

    orig = renderer.Renderer.__call__
    first = {}

    def broken(self, scene):
        image, stats = orig(self, first.setdefault("scene", scene) if how == "stale" else scene)
        if how == "half":  # half of the pixels never rendered
            image = image.clone()
            image.view(-1, 3)[1::2] = 0.0
        elif how == "altered":  # each answer altered where it is produced
            image = image * 1.01
        return image, stats

    monkeypatch.setattr(renderer.Renderer, "__call__", broken)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell, app_root):
    assert _run(cell, app_root)["correct"] is True


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("how", ["stale", "half", "altered"])
def test_broken_render_is_not_correct(monkeypatch, cell, how, app_root):
    _break_render(monkeypatch, how)
    result = _run(cell, app_root)
    assert result["correct"] is False
    assert result["checks"]["pixels_off"]["value"] > result["checks"]["pixels_off"]["limit"]


def test_animation_left_unchanged_is_not_correct(monkeypatch, app_root):
    """The app's state stepped by time alone: the instances never move."""
    from raytracer_tpu_torch.scene import description, scenes

    monkeypatch.setattr(scenes.DynamicScene, "update", description.SceneDescription.update)
    result = _run("dynamic_900x600.app", app_root)
    assert result["correct"] is False
    assert result["checks"]["instance_err"]["value"] > 0


def test_lost_rays_are_not_correct(monkeypatch, app_root):
    from raytracer_tpu_torch.render import renderer

    orig = renderer.Renderer.__call__

    def lossy(self, scene):
        image, stats = orig(self, scene)
        return image, stats._replace(num_incomplete=stats.num_incomplete + 1)

    monkeypatch.setattr(renderer.Renderer, "__call__", lossy)
    result = _run("dynamic_900x600.app", app_root)
    assert result["correct"] is False and result["checks"]["rays_lost"]["value"] > 0
