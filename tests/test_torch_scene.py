"""The port's own copy of the host-side scene code packs exactly what the JAX
package's ScenePacker packs: same fields, dtypes and values (this pins the
SBVH builder, the wide collapse, the texture atlas and the camera copies)."""

import numpy as np
import pytest

from raytracer_tpu.scene import scenes as jax_scenes
from raytracer_tpu.scene.device import ScenePacker as JaxPacker
from raytracer_tpu_torch.accel.wide import records_stack_bound
from raytracer_tpu_torch.scene import scenes as torch_scenes
from raytracer_tpu_torch.scene.device import ScenePacker as TorchPacker
from raytracer_tpu_torch.scene.device import quantised_fields
from raytracer_tpu_torch.scene.tensors import scene_from_numpy
from torch_parity import CONFIG1_TINY, CONFIG3_TINY, private_bvh_cache

QUANTISED = ("wq_rec", "wtq_rec")
PORT_ONLY = (*QUANTISED, "stack_bound")


def _pack(scenes_mod, packer, name):
    with private_bvh_cache():
        return _build(scenes_mod, packer, name)


def _build(scenes_mod, packer, name):
    if name == "config3":
        w, h = CONFIG3_TINY["width"], CONFIG3_TINY["height"]
        desc, _ = scenes_mod.config3_sponza(
            w, h, target_triangles=CONFIG3_TINY["target_triangles"])
    else:
        w, h = CONFIG1_TINY["width"], CONFIG1_TINY["height"]
        desc, _ = scenes_mod.make_scene(name)
    return packer(desc, w, h).frame()


@pytest.mark.parametrize("name", ["config1", "config3"])
def test_packer_matches_jax(name, monkeypatch):
    # both packages read reference assets from the same place (where present)
    monkeypatch.setattr(torch_scenes, "REFERENCE_DATA", jax_scenes.REFERENCE_DATA)
    ref = {k: np.asarray(v) for k, v in _pack(jax_scenes, JaxPacker, name)._asdict().items()}
    ours = _pack(torch_scenes, TorchPacker, name)._asdict()
    # the port also packs quantised copies of the wide records and the walk's
    # stack bound, which the JAX package does not: the same as it derives from
    # the JAX package's arrays
    assert [k for k in ours if k not in PORT_ONLY] == list(ref)
    derived = quantised_fields(ref)
    for k in QUANTISED:
        assert np.array_equal(ours[k], derived[k]), k
    assert ours["stack_bound"] == records_stack_bound(ref["wd_rec"], ref["wt_rec"])
    for k, v in ref.items():
        got = np.asarray(ours[k])
        assert got.dtype == v.dtype, (k, got.dtype, v.dtype)
        assert np.array_equal(got, v), k
    # and through to tensors unchanged
    scene = scene_from_numpy(ours, device="cpu")
    for k, v in ref.items():
        assert np.array_equal(getattr(scene, k).numpy(), v), k
