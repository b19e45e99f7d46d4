"""K7, hit reconstruction: the port's ``mesh_hits_plain`` and its autograd against
the JAX package's ``_mesh_hits_into`` and ``jax.vjp`` on identical numpy lanes
(config3-tiny's primaries, and a config4-tiny frame whose prior record holds K9's
sphere and plane hits); ``MeshHits``' routing with its two launches stubbed;
and the vertex and instance gradients of a render against JAX's."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.blas import build_blas
from raytracer_tpu.config import MeshAccelerator, RenderConfig, TextureSampleMode
from raytracer_tpu.ops import intersect as jax_intersect
from raytracer_tpu.ops import traversal as jax_traversal
from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu.scene import meshgen
from raytracer_tpu.scene.description import PointLight, SceneDescription
from raytracer_tpu.scene.device import pack_scene
from raytracer_tpu_torch.ops import hits, intersect, traversal_wide
from raytracer_tpu_torch.ops.intersect import Hits, Rays
from raytracer_tpu_torch.render import renderer
from torch_parity import fields, jax_frames, jax_scene, l2rel, torch_config, torch_scene

TABLES = hits.GEOMETRY + ("tr_material", "inst_inv", "inst_world")
DIFF_TABLES = hits.GEOMETRY + ("inst_inv", "inst_world")
N_CLAMPED = 8


def _clamped_lanes(n_tri):
    """Eight lanes on instance 0 (the identity in config3) whose triangles, appended
    at rows n_tri.., have |e1 . (d x e2)| = 1e-21 < 1e-20: both Moller-Trumbore's
    and the differentials' denominators are clamped by _nonzero, while (t, u, v)
    stay finite (s . hmt = 0 exactly).  Flat normals and uv keep the 1e20-scaled
    differentials out of the outputs.  Returns (table rows, lane fields)."""
    k = np.arange(N_CLAMPED, dtype=np.float32)
    o = np.stack([0.1 * k, 0.5 + 0.0 * k, -1.0 - 0.25 * k], axis=1)
    s = np.stack([0.0 * k, 0.5 + 0.1 * k, -2.0 - 0.0 * k], axis=1)  # o - p0
    z3 = np.zeros((N_CLAMPED, 3), np.float32)

    def rows(v):
        return np.broadcast_to(np.asarray(v, np.float32), (N_CLAMPED, len(v))).copy()

    tables = dict(tr_p0=(o - s).astype(np.float32), tr_e1=rows([1e-21, 0.0, 0.0]),
                  tr_e2=rows([0.0, 1.0, 0.0]), tr_n0=rows([0.0, 0.0, -1.0]), tr_ne1=z3,
                  tr_ne2=z3, tr_t0=rows([0.25, 0.75]), tr_te1=np.zeros((N_CLAMPED, 2),
                                                                        np.float32),
                  tr_te2=np.zeros((N_CLAMPED, 2), np.float32),
                  tr_material=np.ones((N_CLAMPED,), np.int32))
    rng = np.random.default_rng(4)
    lanes = dict(origin=o.astype(np.float32), direction=rows([0.0, 0.0, 1.0]),
                 dO_dx=(rng.normal(size=(N_CLAMPED, 3)) * 1e-3).astype(np.float32),
                 dO_dy=(rng.normal(size=(N_CLAMPED, 3)) * 1e-3).astype(np.float32),
                 dD_dx=(rng.normal(size=(N_CLAMPED, 3)) * 1e-3).astype(np.float32),
                 dD_dy=(rng.normal(size=(N_CLAMPED, 3)) * 1e-3).astype(np.float32),
                 tri=n_tri + np.arange(N_CLAMPED, dtype=np.int32),
                 inst=np.zeros((N_CLAMPED,), np.int32), steps=np.ones((N_CLAMPED,), np.int32))
    return tables, lanes


def _inputs(scene, cfg, seed, clamped=False) -> dict:
    """numpy K7 inputs: the tables of ``scene``; its primaries with seeded dO (as a
    secondary generation carries them); the ids of the port's plain wide walk
    against the prior record's t; the prior record (K9's on a scene with
    spheres or planes, else the miss record); with ``clamped``, the lanes of
    ``_clamped_lanes`` appended."""
    tscene, tcfg = torch_scene(scene), torch_config(cfg)
    with torch.no_grad():
        rays = renderer.generate_primary_rays(tscene, tcfg)
        n = rays.count
        rng = np.random.default_rng(seed)
        rays = rays._replace(**{k: torch.from_numpy((rng.normal(size=(n, 3)) * 1e-2)
                                                    .astype(np.float32))
                                for k in ("dO_dx", "dO_dy")})
        if tscene.n_spheres + tscene.n_planes:
            winner, t_max = intersect.pick_closest(tscene, rays.origin, rays.direction)
            prior = intersect.primitive_hits(tscene, rays, winner)
        else:
            prior = intersect.make_miss_hits(n, "cpu")
            t_max = prior.t
        bvh = traversal_wide.build_scene_bvh(tscene)
        res = traversal_wide.trace_closest(bvh, rays.origin, rays.direction, t_max,
                                           torch.ones(n, dtype=torch.bool), tcfg)
    f = fields(scene)
    out = {k: f[k] for k in TABLES}
    out.update({k: v.numpy().copy() for k, v in rays._asdict().items()})
    out.update(tri=res.tri.numpy().copy(), inst=res.inst.numpy().copy(),
               steps=res.steps.numpy().copy())
    out.update({f"prior_{k}": v.numpy().copy() for k, v in prior._asdict().items()})
    if clamped:
        tables, lanes = _clamped_lanes(f["tr_p0"].shape[0])
        for k, v in tables.items():
            out[k] = np.concatenate([out[k], v])
        for k, v in lanes.items():
            out[k] = np.concatenate([out[k], v])
        miss = jax_intersect.make_miss_hits(N_CLAMPED)._asdict()
        for k in Hits._fields:
            out[f"prior_{k}"] = np.concatenate([out[f"prior_{k}"], np.asarray(miss[k])])
    return out


def _split(inp, wrap):
    """(scene namespace, {ray field: array}, res namespace, {record field: array})
    of ``inp``, every array passed through ``wrap``."""
    scene = types.SimpleNamespace(**{k: wrap(inp[k]) for k in TABLES})
    rays = {k: wrap(inp[k]) for k in Rays._fields}
    res = types.SimpleNamespace(tri=wrap(inp["tri"]), inst=wrap(inp["inst"]),
                                steps=wrap(inp["steps"]))
    prior = {k: wrap(inp[f"prior_{k}"]) for k in Hits._fields}
    return scene, rays, res, prior


def _jax_hits(inp, object_space):
    def f(inp):
        scene, rays, res, prior = _split(inp, lambda x: x)
        res = jax_traversal.TraceResult(t=jnp.zeros_like(rays["origin"][:, 0]), tri=res.tri,
                                        inst=res.inst, steps=res.steps, incomplete=0)
        out = jax_renderer._mesh_hits_into(scene, jax_intersect.Rays(**rays), res,
                                           jax_intersect.Hits(**prior), object_space)
        return out._asdict()

    return {k: np.asarray(v) for k, v in jax.jit(f)(inp).items()}


def _port_hits(inp, object_space) -> Hits:
    scene, rays, res, prior = _split(inp, torch.from_numpy)
    return hits.mesh_hits_plain(scene, Rays(**rays), res, Hits(**prior), object_space)


@pytest.fixture(scope="module")
def config3_lanes():
    scene, cfg = jax_scene("config3")
    return _inputs(scene, cfg, seed=1, clamped=True)


@pytest.fixture(scope="module")
def config4_lanes():
    frames, cfg = jax_frames("config4", 32, 24, (2,))
    inp = _inputs(frames[0], cfg, seed=2)
    # the prior record holds sphere and plane hits, some of them in front of a mesh
    assert inp["prior_hit"].sum() > 500 and (inp["tri"] >= 0).sum() > 40
    return inp


# XLA:CPU contracts multiply-adds into FMAs, the port rounds each operation
# (ROADMAP C1); grazing lanes (small |a|) amplify that in (u, v), and the uv
# scale (tiling te1, te2) amplifies it again: each float field is held to 3e-5
# of its largest finite magnitude on every lane (measured: uv's v 2.0e-5,
# u 2.8e-6, the normal 5.2e-6, every other field <= 3.0e-6); hit,
# material_id, bvh_steps and the misses' inf t exactly
FWD_TOL = 3e-5


@pytest.mark.parametrize("object_space", [False, True])
@pytest.mark.parametrize("lanes", ["config3_lanes", "config4_lanes"])
def test_mesh_hits_matches_jax(lanes, object_space, request):
    inp = request.getfixturevalue(lanes)
    ref = _jax_hits(inp, object_space)
    with torch.no_grad():
        got = _port_hits(inp, object_space)._asdict()
    for k in ("hit", "material_id", "bvh_steps"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    for k in hits.FLOAT_FIELDS:
        g, r = got[k].numpy(), ref[k]
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
        np.testing.assert_array_equal(g[~fin], r[~fin], err_msg=k)  # the misses' inf t
        scale = max(float(np.abs(r[fin]).max()), 1e-30)
        err = float(np.abs(g[fin] - r[fin]).max()) / scale
        assert err <= FWD_TOL, (k, err)
    valid = inp["tri"] >= 0
    # lanes without a mesh hit keep the prior record, K9's sphere hits among them
    kept = ~valid & inp["prior_hit"]
    if lanes == "config4_lanes":
        assert kept.sum() > 0
    np.testing.assert_array_equal(got["t"].numpy()[~valid], inp["prior_t"][~valid])


def _port_vjp(inp, object_space, cots, wanted):
    """Autograd of mesh_hits_plain: {input name: gradient} for ``wanted`` (ray
    fields, prior_<field>, tables)."""
    scene, rays, res, prior = _split(inp, torch.from_numpy)
    leaves = {}
    for k in wanted:
        if k in Rays._fields:
            rays[k] = leaves[k] = rays[k].clone().requires_grad_()
        elif k.startswith("prior_"):
            f = k[len("prior_"):]
            prior[f] = leaves[k] = prior[f].clone().requires_grad_()
        else:
            leaves[k] = getattr(scene, k).clone().requires_grad_()
            setattr(scene, k, leaves[k])
    out = hits.mesh_hits_plain(scene, Rays(**rays), res, Hits(**prior), object_space)
    total = sum((getattr(out, f) * torch.from_numpy(cots[f])).sum() for f in hits.FLOAT_FIELDS)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return {k: g.numpy() for k, g in zip(leaves, grads)}


def _jax_vjp(inp, object_space, cots, wanted):
    def f(diff, rest):
        full = {**rest, **diff}
        scene, rays, res, prior = _split(full, lambda x: x)
        res = jax_traversal.TraceResult(t=jnp.zeros_like(rays["origin"][:, 0]), tri=res.tri,
                                        inst=res.inst, steps=res.steps, incomplete=0)
        out = jax_renderer._mesh_hits_into(scene, jax_intersect.Rays(**rays), res,
                                           jax_intersect.Hits(**prior), object_space)
        return {k: getattr(out, k) for k in hits.FLOAT_FIELDS}

    @jax.jit
    def vjp(diff, rest, cots):
        return jax.vjp(lambda d: f(d, rest), diff)[1](cots)[0]

    diff = {k: inp[k] for k in wanted}
    rest = {k: v for k, v in inp.items() if k not in wanted}
    return {k: np.asarray(v) for k, v in vjp(diff, rest, cots).items()}


# the port's autograd against jax.vjp, every input within 1e-5 l2-relative
# (measured: config4's inst_inv 7.8e-6, every other input <= 4.6e-6; C1 as in
# the forward)
BWD_TOL = 1e-5


@pytest.mark.parametrize("lanes,object_space", [("config3_lanes", False),
                                                ("config4_lanes", True)])
def test_mesh_hits_vjp_matches_jax(lanes, object_space, request):
    """A seeded cotangent on all 13 float outputs: gradients of the six ray
    fields, the prior record's float fields (they pass through on lanes without
    a mesh hit), the nine triangle tables and both instance tables; config3's
    lanes include the clamped-denominator lanes, config4's a sphere prior."""
    inp = request.getfixturevalue(lanes)
    rng = np.random.default_rng(9)
    cots = {f: rng.normal(size=inp[f"prior_{f}"].shape).astype(np.float32)
            for f in hits.FLOAT_FIELDS}
    wanted = (list(Rays._fields) + [f"prior_{f}" for f in hits.FLOAT_FIELDS]
              + list(DIFF_TABLES))
    ref = _jax_vjp(inp, object_space, cots, wanted)
    got = _port_vjp(inp, object_space, cots, wanted)
    errs = {k: l2rel(got[k], ref[k]) for k in wanted}
    bad = {k: v for k, v in errs.items() if v > BWD_TOL}
    assert not bad, bad
    for k in wanted:
        assert got[k].shape == ref[k].shape and np.isfinite(got[k]).all(), k
    # every gradient is exercised (the world rotation's only through the normal
    # under object-space differentials)
    assert all(np.abs(ref[k]).sum() > 0 for k in wanted), wanted
    valid = inp["tri"] >= 0
    np.testing.assert_array_equal(got["prior_t"][valid], 0.0)
    np.testing.assert_array_equal(got["prior_t"][~valid], cots["t"][~valid])


def _stub_forward(calls):
    def fwd(tri, inst, steps, rays, geom, material, inv, world, prior, object_space):
        calls.append(("fwd", tri.device.type))
        scene = types.SimpleNamespace(**dict(zip(hits.GEOMETRY, geom)), tr_material=material,
                                      inst_inv=inv, inst_world=world)
        res = types.SimpleNamespace(tri=tri, inst=inst, steps=steps)
        return hits.mesh_hits_plain(scene, rays, res, prior, object_space)

    return fwd


def _stub_backward(calls):
    def bwd(tri, inst, rays, geom, material, inv, world, cots, object_space, need_rays,
            need_prior, need_geom, need_inst):
        calls.append(("bwd", tuple(need_rays), tuple(need_prior), tuple(need_geom),
                      tuple(need_inst)))
        with torch.enable_grad():
            ray_l = [x.detach().requires_grad_() for x in rays]
            geom_l = [x.detach().requires_grad_() for x in geom]
            inv_l, world_l = inv.detach().requires_grad_(), world.detach().requires_grad_()
            n = tri.shape[0]
            prior = intersect.make_miss_hits(n, "cpu")
            prior_l = {f: getattr(prior, f).clone().requires_grad_() for f in hits.FLOAT_FIELDS}
            scene = types.SimpleNamespace(**dict(zip(hits.GEOMETRY, geom_l)),
                                          tr_material=material, inst_inv=inv_l,
                                          inst_world=world_l)
            res = types.SimpleNamespace(tri=tri, inst=inst, steps=torch.zeros_like(tri))
            out = hits.mesh_hits_plain(scene, Rays(*ray_l), res,
                                       prior._replace(**prior_l), object_space)
            leaves = ray_l + list(prior_l.values()) + geom_l + [inv_l, world_l]
            g = torch.autograd.grad([getattr(out, f) for f in hits.FLOAT_FIELDS], leaves, cots)
        flags = list(need_rays) + list(need_prior) + list(need_geom) + list(need_inst)
        g = [x if k else None for x, k in zip(g, flags)]
        return g[:6], g[6:19], g[19:28], g[28], g[29]

    return bwd


def _apply(scene, rays, res, prior, object_space):
    return Hits(*hits.MeshHits.apply(
        object_space, res.tri, res.inst, res.steps, scene.tr_material,
        *(getattr(scene, k) for k in hits.GEOMETRY), scene.inst_inv, scene.inst_world,
        *rays, *prior))


def test_mesh_hits_function_plumbing(config4_lanes, monkeypatch):
    """MeshHits with its two launches replaced by the plain version: its outputs,
    its gradients and the flags it hands the backward launch (only the inputs
    that require grad: some ray fields, some tables, some prior fields) equal
    autograd of mesh_hits_plain; hit, material_id and bvh_steps carry none."""
    inp = config4_lanes
    calls = []
    monkeypatch.setattr(hits, "hits_forward", _stub_forward(calls))
    monkeypatch.setattr(hits, "hits_backward", _stub_backward(calls))
    wanted = {"origin", "dD_dx", "tr_p0", "tr_te2", "inst_world", "prior_t", "prior_normal"}
    rng = np.random.default_rng(10)
    cots = {f: torch.from_numpy(rng.normal(size=inp[f"prior_{f}"].shape).astype(np.float32))
            for f in hits.FLOAT_FIELDS}
    results = []
    for through_function in (True, False):
        scene, rays, res, prior = _split(inp, torch.from_numpy)
        leaves = {}
        for k in sorted(wanted):
            if k in rays:
                rays[k] = leaves[k] = rays[k].clone().requires_grad_()
            elif k.startswith("prior_"):
                prior[k[6:]] = leaves[k] = prior[k[6:]].clone().requires_grad_()
            else:
                leaves[k] = getattr(scene, k).clone().requires_grad_()
                setattr(scene, k, leaves[k])
        args = (scene, Rays(**rays), res, Hits(**prior), True)
        out = _apply(*args) if through_function else hits.mesh_hits_plain(*args)
        assert not any(getattr(out, k).requires_grad
                       for k in ("hit", "material_id", "bvh_steps"))
        g = torch.autograd.grad([getattr(out, f) for f in hits.FLOAT_FIELDS],
                                list(leaves.values()), [cots[f] for f in hits.FLOAT_FIELDS])
        results.append((out, dict(zip(leaves, g))))
    (out, grads), (ref_out, ref_grads) = results
    for a, b, name in zip(out, ref_out, Hits._fields):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=name)
    for k in wanted:
        np.testing.assert_allclose(grads[k].numpy(), ref_grads[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert [c[0] for c in calls] == ["fwd", "bwd"] and calls[0][1] == "cpu"
    _, need_rays, need_prior, need_geom, need_inst = calls[1]
    assert need_rays == tuple(f in wanted for f in Rays._fields)
    assert need_prior == tuple(f"prior_{f}" in wanted for f in hits.FLOAT_FIELDS)
    assert need_geom == tuple(f in wanted for f in hits.GEOMETRY)
    assert need_inst == (False, True)


def test_mesh_hits_launches_off_the_cpu(config4_lanes, monkeypatch):
    """Tensors off the CPU go through MeshHits to the launch, and nothing falls
    back to the plain version: on the ``meta`` device (no data) the stubbed
    launch receives them, and the real one refuses them."""
    scene, rays, res, prior = _split(config4_lanes, lambda x: torch.from_numpy(x).to("meta"))
    args = (scene, Rays(**rays), res, Hits(**prior), False)
    plain = []
    monkeypatch.setattr(hits, "mesh_hits_plain", lambda *a: plain.append(1))
    with pytest.raises(ValueError, match="CUDA tensors expected"):
        hits.mesh_hits(*args)
    calls = []
    monkeypatch.setattr(hits, "hits_forward", lambda *a: calls.append(a[0].device.type)
                        or Hits(*(torch.empty_like(x) for x in a[8])))
    out = hits.mesh_hits(*args)
    assert calls == ["meta"] and not plain and out.t.device.type == "meta"


def _icosphere_scene(cfg):
    """test_gradients.py:test_grad_mesh_vertices' scene: one icosphere instance,
    a point light, a grey sky."""
    desc = SceneDescription(camera_fov_deg=90.0)
    desc.set_sky(np.full((16, 3), 0.4, np.float32), 4)
    desc.register_blas("ico", build_blas(meshgen.icosphere(1.0, 1), MeshAccelerator.BVH,
                                         cache_dir=None))
    desc.add_instance("ico", (0.15, 0.1, 4.0))
    desc.point_lights.append(PointLight(np.array([15.0, 15.0, 15.0]),
                                        np.array([2.0, 5.0, 0.0])))
    desc.camera.position = np.zeros(3)
    return pack_scene(desc, cfg.width, cfg.height)


def test_vertex_grads_match_jax():
    """Gradients of a weighted image sum with respect to the triangle tables and
    the instance matrices (test_gradients.py:137's scene, 16x16, no bounce: the
    icosphere's material spawns none), the port's autograd through K7 against
    jax.grad: each within 1e-4 l2-relative (measured <= 1.2e-5)."""
    cfg = jax_renderer.lossless_fallback_config(RenderConfig(
        width=16, height=16, num_bounces=0, traversal_chunk=256,
        texture_sample_mode=TextureSampleMode.BILINEAR))
    scene = _icosphere_scene(cfg)
    w = np.sin(np.arange(16 * 16 * 3, dtype=np.float32)).reshape(16, 16, 3) + 1.0

    def loss(p):
        img, _ = jax_renderer.render_with_stats(scene._replace(**p), cfg)
        return jnp.sum(img * w)

    names = DIFF_TABLES
    ref = jax.jit(jax.grad(loss))({k: getattr(scene, k) for k in names})
    tscene = torch_scene(scene)
    leaves = {k: getattr(tscene, k).clone().requires_grad_() for k in names}
    img, _ = renderer.render_with_stats(tscene._replace(**leaves), torch_config(cfg))
    grads = torch.autograd.grad((img * torch.from_numpy(w)).sum(), list(leaves.values()),
                                allow_unused=True)
    for k, g in zip(names, grads):
        r = np.asarray(ref[k])
        g = np.zeros_like(r) if g is None else g.numpy()
        assert np.isfinite(g).all(), k
        if k in ("tr_t0", "tr_te1", "tr_te2"):  # no texture: uv reaches nothing
            assert not r.any() and not g.any(), k
        else:
            assert np.abs(r).sum() > 0 and l2rel(g, r) <= 1e-4, (k, l2rel(g, r))
