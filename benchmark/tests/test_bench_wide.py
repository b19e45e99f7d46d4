"""The cell on the port's default walk, ``sponza_1080p.flythrough``, at a tiny size
on the CPU: the reference against the program, the control, the cell through the
harness, and the frozen walk that prices K1/K2's roofline against the program's
plain walk."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program
from benchmark.metrics import _wide_walk
from benchmark.reference import compare
from benchmark.reference.render import Reference
from benchmark.yardstick.scenes import sponza

CELL, CONFIG = "sponza_1080p.flythrough", "sponza_1080p"
TINY = {"resolution": [48, 27], "triangles": 20000}


@pytest.fixture(scope="module")
def rendered():
    from raytracer_tpu_torch.render.renderer import Renderer
    from raytracer_tpu_torch.scene.device import ScenePacker

    config = {**harness.configuration(harness.benchmark(), CONFIG), **TINY}
    raw = sponza.build(config)
    desc = program.description(raw, config["program_scene"])
    cfg = program.render_config(config)
    rend = Renderer(cfg, device="cpu")
    scene = rend.upload(ScenePacker(desc, cfg.width, cfg.height).frame())
    image, stats = rend(scene)
    return config, raw, cfg, scene, image, stats


def test_the_configuration_walks_the_wide_bvh(rendered):
    config, _, cfg, *_ = rendered
    assert config["traversal_kernel"] == "wide" and cfg.traversal_kernel == "wide"
    assert cfg.wide_stack_size is None  # the scene's proven bound


def test_reference_matches_the_program(rendered):
    config, raw, _, _, image, stats = rendered
    ref = Reference(raw, config, "cpu")
    pixels = torch.arange(config["resolution"][0] * config["resolution"][1])
    want = ref.render(ref.camera(raw.camera_position, raw.camera_rotation), pixels)
    assert compare.share_off(image.reshape(-1, 3), want, 1e-3) <= 1e-3
    assert int(stats.num_dropped) == 0 and int(stats.num_incomplete) == 0


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_through_the_harness(trace):
    result = harness.run(CELL, 2**31 + 23, 0.5, trace, device="cpu", overrides=TINY)
    assert result["correct"] is True
    if trace:  # no K1/K2 event on the CPU: the two readers find nothing
        assert not {"wide_walk_ms.kernels", "wide_walk_roofline.kernels"} & set(
            result["metrics"])
    else:
        assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def test_control_run_is_not_correct():
    result = harness.run(CELL, 2**31 + 11, 0.5, False, device="cpu", overrides=TINY,
                         control=True)
    assert result["correct"] is False
    assert result["checks"]["pixels_off"]["value"] > result["checks"]["pixels_off"]["limit"]


def test_frozen_walk_visits_as_the_program_walks(rendered):
    """The frozen walk visits the nodes and leaves the program's plain walk visits,
    closest and any hit, on the frame's primary rays and on rays toward a light."""
    from raytracer_tpu_torch.ops import traversal_wide

    *_, cfg, scene, _, _ = rendered
    bvh = traversal_wide.build_scene_bvh(scene)
    g = torch.Generator().manual_seed(5)
    n = 512
    o = (scene.cam_pos + 0.05 * torch.randn(n, 3, generator=g)).contiguous()
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).contiguous()
    t_max = torch.full((n,), float("inf"))
    active = torch.ones(n, dtype=torch.bool)
    for any_hit in (False, True):
        tm = torch.full((n,), 40.0) if any_hit else t_max
        w = traversal_wide.trace_plain(bvh, o, d, tm, active, None, True, any_hit)
        c = _wide_walk.count(any_hit, bvh, True, o, d, tm)
        assert int(w.incomplete) == 0
        assert (c["nodes"], c["leaves"]) == (int(w.steps.sum()), int(w.leaves.sum()))
        assert c["children"] >= c["nodes"] and c["triangles"] >= c["leaves"]
        assert 0 < c["rows"] <= bvh.table.shape[0]


def test_roofline_reader_prices_the_profiled_frames():
    """The reader renders the profiled poses again, restores the walk's functions,
    and divides the bound by the frames' K1/K2 time (here a made-up 1 ms a frame)."""
    from benchmark.loops.flythrough import Loop
    from raytracer_tpu_torch.ops import traversal_wide

    config = {**harness.configuration(harness.benchmark(), CONFIG), **TINY}
    m = harness.mix("flythrough")
    loop = Loop(config, {**m, "warmup_frames": 0}, 3, "cpu",
                SimpleNamespace(span=lambda name: contextlib.nullcontext()))
    loop.setup()
    saved = traversal_wide.trace_closest, traversal_wide.trace_any
    profile = SimpleNamespace(frames=2, device_ms=lambda part: 2.0 if part == "quant_kernel<"
                              else 0.0)
    ctx = SimpleNamespace(profile=profile, profiled=[0, 1], loop=loop)
    reader = harness.reader("wide_walk_roofline.kernels")
    share = reader.read(ctx)
    assert (traversal_wide.trace_closest, traversal_wide.trace_any) == saved
    assert 0.0 < share < 100.0
    assert harness.reader("wide_walk_ms.kernels").read(ctx) == 1.0
    assert reader.read(SimpleNamespace(profile=None, profiled=[], loop=loop)) is None
