"""The port's debug validators and .obj dumpers (``raytracer_tpu_torch.utils.debug``)
against the JAX package's: the same seeded inputs give the same lanes, and the
dumpers write the same bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import vecmath as jvm
from raytracer_tpu.utils import debug as jax_debug
from raytracer_tpu_torch.utils import debug


def _refraction_lanes(n=256, seed=0):
    """Unit directions against facing normals, refracted from n1 = 1 into
    n2 = 1.5, as tests/test_utils.py builds them; then lanes that break each
    check: a wrong refracted direction, a direction that is not unit length, a
    refracted direction that is not unit length, and a normal on the wrong
    side."""
    rng = np.random.default_rng(seed)
    d = jvm.normalize(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))
    nrm = jvm.normalize(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))
    nrm = jnp.where(jvm.dot(d, nrm)[:, None] > 0, -nrm, nrm)
    n1 = jnp.full((n,), 1.0, jnp.float32)
    n2 = jnp.full((n,), 1.5, jnp.float32)
    cos = -jvm.dot(d, nrm)
    eta = n1 / n2
    k = 1.0 - eta * eta * (1.0 - cos * cos)
    r = np.array(jvm.refract(d, nrm, eta, cos, k))
    d, nrm = np.array(d), np.array(nrm)
    r[0:8] = rng.normal(size=(8, 3))  # not Snell's angle
    d[8:16] *= 1.01  # |direction| off by 1e-2
    r[16:24] *= 1.05  # |refracted| off by 5e-2
    nrm[24:32] *= -1.0  # wrong hemisphere
    mask = np.array(k > 0)
    mask[32:40] = False  # masked lanes pass whatever they hold
    r[32:40] = 0.0
    return [np.array(x, np.float32) for x in (n1, n2, d, nrm, r)] + [mask]


@pytest.mark.parametrize("tol", [1e-3, 1e-1])
def test_check_refraction_matches_jax(tol):
    n1, n2, d, nrm, r, mask = _refraction_lanes()
    want = np.asarray(jax_debug.check_refraction(
        *(jnp.asarray(x) for x in (n1, n2, d, nrm, r, mask)), tol=tol))
    got = debug.check_refraction(*(torch.from_numpy(x) for x in (n1, n2, d, nrm, r, mask)),
                                 tol=tol)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # every kind of lane is there: passing, failing, and masked out
    assert want[:32].sum() < 32 and want[32:40].all() and want[40:].sum() > 0


@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf])
def test_is_finite_matches_jax(bad):
    x = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    if bad is not None:
        x[3, 1] = bad
    assert debug.is_finite(torch.from_numpy(x)) == jax_debug.is_finite(jnp.asarray(x))


def test_obj_dumpers_write_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(2)
    p0, p1, p2 = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    lo = rng.normal(size=(4, 3))
    hi = lo + rng.uniform(0.1, 1.0, size=(4, 3))
    for name, ours, ref, args in (
        ("tris", debug.obj_write_triangles, jax_debug.obj_write_triangles, (p0, p1, p2)),
        ("boxes", debug.obj_write_aabbs, jax_debug.obj_write_aabbs, (lo, hi)),
    ):
        ours(str(tmp_path / f"{name}_port.obj"), *args)
        ref(str(tmp_path / f"{name}_jax.obj"), *args)
        text = (tmp_path / f"{name}_port.obj").read_bytes()
        assert text == (tmp_path / f"{name}_jax.obj").read_bytes()
    # the boxes' faces index their own 8 vertices (1-based, 8 per box)
    faces = [line.split()[1:] for line in text.decode().splitlines() if line.startswith("f ")]
    assert len(faces) == 6 * 4
    for k in range(4):
        assert {int(i) for f in faces[6 * k:6 * k + 6] for i in f} == set(range(8 * k + 1,
                                                                                8 * k + 9))
