"""Spheres and planes (K9 plain path + the re-derived hit record) against the JAX
package's chain of sphere_trace / plane_trace and sphere_intersect /
plane_intersect, forward and gradients, on seeded rays with the hard cases:
origins inside a sphere, grazing rays, rays parallel to a plane, rays that hit
nothing, and equal t on two primitives."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import intersect as jint
from raytracer_tpu_torch.ops import intersect

# spheres 0 and 1 are the same sphere (equal t: sphere 0 must win); sphere 2
# holds the origins of the inside rays; the planes are y = -1 and z = 20
SPH_C = np.array([[0, 0, 5], [0, 0, 5], [2, 0.5, 8]], np.float32)
SPH_R = np.array([1.0, 1.0, 1.5], np.float32)
SPH_M = np.array([3, 4, 5], np.int32)
PLN_N = np.array([[0, 1, 0], [0, 0, -1]], np.float32)
PLN_D = np.array([1.0, 20.0], np.float32)
PLN_U = np.array([[1, 0, 0], [1, 0, 0]], np.float32)
PLN_V = np.array([[0, 0, 1], [0, 1, 0]], np.float32)
PLN_M = np.array([6, 7], np.int32)

# fields compared, and the seeded scalar's weights are drawn per float field
FLOAT_FIELDS = ("t", "point", "normal", "u", "v", "ds_dx", "ds_dy", "dt_dx", "dt_dy",
                "dO_dx", "dO_dy", "dN_dx", "dN_dy")
RAY_FIELDS = ("origin", "direction", "dO_dx", "dO_dy", "dD_dx", "dD_dy")


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rays(seed=0, n=4000):
    """Seeded rays: random ones plus each hard case (rows tagged in ``kind``)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3, -0.5, -2], [3, 3, 3], (n, 3))
    d = _unit(rng.normal(size=(n, 3)) + [0, -0.2, 1.5])
    kinds = {"random": n}
    # origins inside sphere 2
    m = 200
    o = np.concatenate([o, SPH_C[2] + rng.uniform(-0.6, 0.6, (m, 3))])
    d = np.concatenate([d, _unit(rng.normal(size=(m, 3)))])
    kinds["inside"] = m
    # grazing sphere 0: rays along +z at distance ~r from its axis
    ang = rng.uniform(0, 2 * np.pi, m)
    rad = 1.0 + rng.uniform(-1e-3, 1e-3, m)
    o = np.concatenate([o, np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros(m)], 1)])
    d = np.concatenate([d, np.tile([[0.0, 0.0, 1.0]], (m, 1))])
    kinds["grazing"] = m
    # parallel to the floor (d.y = 0), some of them also parallel to z = 20
    dp = rng.normal(size=(m, 3))
    dp[:, 1] = 0.0
    dp[: m // 2, 2] = 0.0
    o = np.concatenate([o, rng.uniform([-3, 2.0, -2], [3, 3, 0], (m, 3))])
    d = np.concatenate([d, _unit(dp)])
    kinds["parallel"] = m
    # hitting nothing: up and away
    o = np.concatenate([o, rng.uniform([-3, 2, -2], [3, 3, 0], (m, 3))])
    away = rng.normal(size=(m, 3)) * [0.3, 0, 0] + [0, 1, -0.5]
    d = np.concatenate([d, _unit(away)])
    kinds["nothing"] = m
    rays = {"origin": o, "direction": d}
    for f in RAY_FIELDS[2:]:
        rays[f] = rng.normal(scale=1e-3, size=o.shape)
    return {k: v.astype(np.float32) for k, v in rays.items()}, kinds


def _prims(to):
    return types.SimpleNamespace(
        sph_center=to(SPH_C), sph_radius=to(SPH_R), sph_material=to(SPH_M),
        pln_normal=to(PLN_N), pln_distance=to(PLN_D), pln_u=to(PLN_U), pln_v=to(PLN_V),
        pln_material=to(PLN_M))


def _weights(seed=1):
    rng = np.random.default_rng(seed)
    return {f: rng.normal() for f in FLOAT_FIELDS}


def _scalar(hits, w, where, xp_sum):
    """Seeded weighted sum of every float field (t only where hit)."""
    total = 0.0
    for f in FLOAT_FIELDS:
        x = getattr(hits, f)
        if f == "t":
            x = where(hits.hit, x, 0.0)
        total = total + w[f] * xp_sum(x)
    return total


def _jax_chain(rays_np, w):
    """(Hits, d scalar / d ray fields) of the JAX chain, un-jitted as the
    renderer's trace_scene runs it."""
    def hits_of(r):
        rays = jint.Rays(*(r[f] for f in RAY_FIELDS))
        hits = jint.make_miss_hits(rays.count)
        for i in range(len(SPH_R)):
            hits = jint.sphere_trace(rays, hits, SPH_C[i], SPH_R[i], SPH_M[i])
        for i in range(len(PLN_D)):
            hits = jint.plane_trace(rays, hits, PLN_N[i], PLN_D[i], PLN_U[i], PLN_V[i],
                                    PLN_M[i])
        return hits

    r = {k: jnp.asarray(v) for k, v in rays_np.items()}
    hits = hits_of(r)
    grads = jax.grad(lambda r: _scalar(hits_of(r), w, jnp.where, jnp.sum))(r)
    return hits, {k: np.asarray(v) for k, v in grads.items()}


def _port_chain(rays_np, w):
    prims = _prims(torch.from_numpy)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in rays_np.items()}
    rays = intersect.Rays(*(leaves[f] for f in RAY_FIELDS))
    winner, t_pick = intersect.pick_closest(prims, rays.origin.detach(),
                                            rays.direction.detach())
    hits = intersect.primitive_hits(prims, rays, winner)
    _scalar(hits, w, torch.where, torch.sum).backward()
    return hits, winner, t_pick, {k: v.grad.numpy() for k, v in leaves.items()}


@pytest.fixture(scope="module")
def chains():
    rays, kinds = _rays()
    w = _weights()
    return rays, kinds, _jax_chain(rays, w), _port_chain(rays, w)


def _lanes(kinds, name):
    start = 0
    for k, m in kinds.items():
        if k == name:
            return slice(start, start + m)
        start += m
    raise KeyError(name)


def test_pick_and_hit_record_match_jax(chains):
    rays, kinds, (jhits, _), (hits, winner, t_pick, _) = chains
    jhit = np.asarray(jhits.hit)
    # every hard case is present in the inputs
    w = winner.numpy()
    assert (w[_lanes(kinds, "inside")] == 2).all()
    assert (w[_lanes(kinds, "nothing")] == -1).all()
    assert (w == 1).sum() == 0 and (w == 0).sum() > 100  # ties go to sphere 0
    assert ((w >= 3).sum() > 100) and (w[_lanes(kinds, "parallel")] == -1).any()
    # the pick's t is the re-derived t, bit for bit (it is K1's t_max)
    assert torch.equal(t_pick, hits.t)
    # the same winners as the JAX chain: equal hit flags and materials
    assert np.array_equal(hits.hit.numpy(), jhit)
    assert np.array_equal(hits.material_id.numpy(), np.asarray(jhits.material_id))
    assert np.array_equal(hits.bvh_steps.numpy(), np.asarray(jhits.bvh_steps))
    # every float field within 1e-6 relative to its field's scale (measured:
    # t, point, normal and the differentials equal; u, v and the texture
    # derivatives within 1e-10, atan2 / acos rounding apart)
    for f in FLOAT_FIELDS:
        a, b = getattr(hits, f).detach().numpy(), np.asarray(getattr(jhits, f))
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), f
        scale = np.abs(b[fin]).max()
        assert np.abs(a[fin] - b[fin]).max() <= 1e-6 * scale, (f, np.abs(a[fin] - b[fin]).max())


def test_gradients_match_jax(chains):
    """d (seeded weighted sum of the hit record) / d (origin, direction and the
    four differentials): torch autograd against jax.grad, within 1e-5
    l2-relative (measured <= 1.6e-7, the origin's; grazing lanes, where
    1/sqrt(disc) amplifies rounding, included)."""
    _rays_np, _kinds, (_, jgrads), (_, _, _, grads) = chains
    for f in RAY_FIELDS:
        g, r = grads[f], jgrads[f]
        assert np.isfinite(g).all(), f
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel <= 1e-5, (f, rel)


def test_any_hit_matches_jax():
    """pick_any_plain against the OR of sphere_intersect / plane_intersect, with
    seeded max distances (some inside a blocker) and inactive lanes."""
    rays, _ = _rays(seed=5)
    n = rays["origin"].shape[0]
    rng = np.random.default_rng(6)
    tmax = rng.uniform(0.0, 25.0, n).astype(np.float32)
    tmax[::7] = np.inf
    active = rng.random(n) < 0.9
    jr = jint.Rays(*(jnp.asarray(rays[f]) for f in RAY_FIELDS))
    ref = np.zeros(n, bool)
    for i in range(len(SPH_R)):
        ref |= np.asarray(jint.sphere_intersect(jr, tmax, SPH_C[i], SPH_R[i]))
    for i in range(len(PLN_D)):
        ref |= np.asarray(jint.plane_intersect(jr, tmax, PLN_N[i], PLN_D[i]))
    got = intersect.pick_any(_prims(torch.from_numpy), torch.from_numpy(rays["origin"]),
                             torch.from_numpy(rays["direction"]), torch.from_numpy(tmax),
                             torch.from_numpy(active))
    assert ref[active].any() and not ref[active].all()
    assert np.array_equal(got.numpy(), ref & active)


def test_no_primitives_and_refused_gradients():
    """An empty scene picks nothing; the pick refuses inputs that ask for a
    gradient on the card only (the CPU path is the plain version)."""
    empty = types.SimpleNamespace(sph_center=torch.zeros(0, 3), sph_radius=torch.zeros(0),
                                  pln_normal=torch.zeros(0, 3), pln_distance=torch.zeros(0))
    o = torch.zeros(5, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(5, 3).contiguous()
    winner, t = intersect.pick_closest(empty, o, d)
    assert (winner == -1).all() and torch.isinf(t).all()
    assert not intersect.pick_any(empty, o, d, torch.full((5,), 1e9),
                                  torch.ones(5, dtype=torch.bool)).any()
