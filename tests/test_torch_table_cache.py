"""``Renderer``'s table cache (``render/renderer.py``: ``_table_key``,
``Renderer._scene_tables``): a frame's traversal table and quad atlas are built
once a scene and reused while the tensors they are built from are the same
objects at the same version; a camera moved through the scene reuses them, a
new or edited table field builds them again, and every frame is bit for bit
the frame built fresh.  On the CPU, on ``tests/test_torch_trace.py``'s tiny
scene; the last test needs a CUDA card and skips without one (on a machine
with a card: ``python -m pytest tests/test_torch_table_cache.py -m gpu
--noconftest -q``)."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import TextureSampleMode
from raytracer_tpu_torch.core import quaternion as quat
from raytracer_tpu_torch.ops import texture_sample, traversal, traversal_wide
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import scenes
from raytracer_tpu_torch.scene.device import ScenePacker, pack_scene
from raytracer_tpu_torch.utils import trace
from test_torch_trace import CFG, _desc

CAMERA = ("cam_pos", "cam_top_left", "cam_x", "cam_y")
KEYS = ("tables.build", "tables.reuse")

# (config, whether the scene has an instance): both walks, a configuration
# without a quad atlas, and a scene without a table
CASES = {
    "threaded": (CFG, True),
    "wide": (CFG.replace(traversal_kernel="wide"), True),
    "nearest": (CFG.replace(texture_sample_mode=TextureSampleMode.NEAREST), True),
    "no_instances": (CFG, False),
}


def _poses(instance: bool):
    """The packed scene at two camera poses."""
    desc = _desc(instance)
    first = pack_scene(desc, CFG.width, CFG.height)
    desc.camera.position = np.array([0.4, 1.2, 0.3])
    desc.camera.rotation = quat.axis_angle([0.0, 1.0, 0.0], 0.1)
    return first, pack_scene(desc, CFG.width, CFG.height)


@pytest.fixture(scope="module")
def packed():
    return {instance: _poses(instance) for instance in (True, False)}


def _counts():
    return [trace.counters[k] for k in KEYS]


def _same_bits(a, b) -> bool:
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _same_frame(got, want) -> bool:
    (img, stats), (img_w, stats_w) = got, want
    return _same_bits(img, img_w) and all(_same_bits(a, b) for a, b in zip(stats, stats_w))


def _poses_uploaded(rend, poses):
    """The first pose uploaded, and the second as the flythrough makes it: the
    first's tensors with the second's camera fields."""
    first = rend.upload(poses[0])
    cams = rend.upload(poses[1])
    return first, first._replace(**{f: getattr(cams, f) for f in CAMERA})


def _fresh(scene, cfg):
    with torch.no_grad():
        return renderer.render_with_stats(scene, cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_a_camera_move_reuses_the_tables(packed, case):
    """A renderer called on a scene, then on the scene with another pose's
    camera fields, builds once and reuses once, and both frames are those of
    ``render_with_stats`` bit for bit; the kept tables are the case's (no
    table without an instance, no quad atlas under NEAREST)."""
    cfg, instance = CASES[case]
    rend = renderer.Renderer(cfg, device="cpu")
    first, second = _poses_uploaded(rend, packed[instance])
    before = _counts()
    frames = [rend(first), rend(second)]
    assert _counts() == [before[0] + 1, before[1] + 1]
    for got, scene in zip(frames, (first, second)):
        assert _same_frame(got, _fresh(scene, cfg))
    assert not _same_bits(frames[0][0], frames[1][0])
    bvh, tex4 = rend._tables
    assert (bvh is None) == (not instance)
    assert (tex4 is None) == (cfg.texture_sample_mode == TextureSampleMode.NEAREST)


def _edits():
    """(walk, field, how) for every field the tables are built from."""
    out = []
    for walk, mod in (("threaded", traversal), ("wide", traversal_wide)):
        for field in (*mod.TABLE_FIELDS, *texture_sample.QUAD_FIELDS):
            out += [(walk, field, how) for how in ("new", "in_place")
                    if not (field == "stack_bound" and how == "in_place")]
    return out


@pytest.mark.parametrize("walk,field,how", _edits())
def test_a_changed_table_field_rebuilds(packed, walk, field, how):
    """Replacing a table field with a new tensor (a new value for the Python
    int ``stack_bound``), or writing one in place (``add_(0)`` bumps its
    version), makes the next frame build, and that frame is the fresh one."""
    cfg = CASES[walk][0]
    rend = renderer.Renderer(cfg, device="cpu")
    scene, _ = _poses_uploaded(rend, packed[True])
    rend(scene)
    if how == "in_place":
        getattr(scene, field).add_(0)
    elif field == "stack_bound":
        scene = scene._replace(stack_bound=scene.stack_bound + 1)
    else:
        scene = scene._replace(**{field: getattr(scene, field).clone()})
    before = _counts()
    got = rend(scene)
    assert _counts() == [before[0] + 1, before[1]]
    assert _same_frame(got, _fresh(scene, cfg))
    rend(scene)
    assert _counts() == [before[0] + 1, before[1] + 1]


def test_an_instance_moved_in_place_renders_the_new_scene(packed):
    """An in-place write that changes the geometry (the instance's inverse
    transform, through a view) is seen: the next frame is the moved scene's,
    not the kept tables'."""
    rend = renderer.Renderer(CFG, device="cpu")
    scene, _ = _poses_uploaded(rend, packed[True])
    still = rend(scene)
    scene.inst_inv[0, :, 3].add_(0.5)
    moved = rend(scene)
    assert _same_frame(moved, _fresh(scene, CFG))
    assert not _same_bits(moved[0], still[0])


def test_an_app_loop_builds_every_frame(packed):
    """A scene uploaded anew every frame (the app's loop) builds every frame
    and renders as ``render_with_stats``."""
    rend = renderer.Renderer(CFG, device="cpu")
    for poses in (packed[True], packed[True]):
        before = _counts()
        scene = rend.upload(poses[1])
        got = rend(scene)
        assert _counts() == [before[0] + 1, before[1]]
        assert _same_frame(got, _fresh(scene, CFG))


def test_inference_tensors_build_every_frame(packed):
    """A scene of inference tensors keeps no version counter: every frame
    builds, and nothing is kept."""
    rend = renderer.Renderer(CFG, device="cpu")
    with torch.inference_mode():
        scene = rend.upload(packed[True][0])
        for _ in range(2):
            before = _counts()
            got = rend(scene)
            assert _counts() == [before[0] + 1, before[1]]
            assert rend._tables is None
    assert _same_frame(got, _fresh(scene, CFG))


def test_a_gradient_render_builds_its_own_tables(packed):
    """Under autograd ``render_with_stats`` builds its tables every call, past a
    renderer that keeps the same scene's: no table counter moves, and the
    gradient of a ``tex_data`` that asks for one is that of a quad atlas built
    with autograd and handed in."""
    rend = renderer.Renderer(CFG, device="cpu")
    scene, _ = _poses_uploaded(rend, packed[True])
    scene.tex_data.requires_grad_()
    rend(scene)
    rend(scene)
    assert rend._tables[1] is not None and not rend._tables[1].requires_grad
    before = _counts()
    with torch.enable_grad():
        img, _ = renderer.render_with_stats(scene, CFG)
        (grad,) = torch.autograd.grad(img.square().sum(), scene.tex_data)
        tex4 = texture_sample.expand_quads(renderer._tex_tuple(scene))
        rgb, _ = renderer.render_wavefront(scene, CFG, tex4=tex4)
        (want,) = torch.autograd.grad(rgb.square().sum(), scene.tex_data)
    assert _counts() == before
    assert float(grad.abs().sum()) > 0 and _same_bits(grad, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("walk", ["threaded", "wide"])
def test_a_kept_frame_on_the_card_is_the_fresh_one(cuda, monkeypatch, walk):
    """On the card, config3 at a small size: a second frame from the kept
    tables (another pose's camera) gives the image, the stats and every
    generation's shadow ``found`` of a fresh build, bit for bit."""
    desc, cfg = scenes.config3_sponza(96, 54, target_triangles=20_000)
    cfg = cfg.replace(width=96, height=54, traversal_kernel=walk)
    rend = renderer.Renderer(cfg, device=cuda)
    first = rend.upload(ScenePacker(desc, cfg.width, cfg.height).frame())
    desc.camera.position = desc.camera.position + np.array([0.5, 0.2, -0.3])
    cams = rend.upload(ScenePacker(desc, cfg.width, cfg.height).frame())
    second = first._replace(**{f: getattr(cams, f) for f in CAMERA})
    mod = traversal if walk == "threaded" else traversal_wide
    found, trace_any = [], mod.trace_any

    def kept_any(*args):
        out = trace_any(*args)
        found.append(out[0].clone())
        return out

    monkeypatch.setattr(mod, "trace_any", kept_any)
    rend(first)
    found.clear()
    before = _counts()
    got = rend(second)
    assert _counts() == [before[0], before[1] + 1]
    kept, found[:] = list(found), []
    want = _fresh(second, cfg)
    assert _same_frame(got, want)
    assert len(kept) == len(found) > 0
    assert all(_same_bits(a, b) for a, b in zip(kept, found))
