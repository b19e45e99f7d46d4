"""K11-K13 (``raytracer_tpu_torch/ops/gather.py``) against the Pallas kernels of the
row-gather harnesses in ``scratch/``, run in Pallas's TPU interpret mode on the CPU.

Each harness module is loaded by path (``scratch/`` is no package) and its size
constants, which its functions read as module globals at call time, are shrunk
on the module object.  ``bench_pallas_gather.py``'s kernels are closures inside
its ``main()``: its ``row_kernel`` is held to the harness's own reference,
``jnp.take`` (``:81``), and its ``block_kernel`` is, line for line,
``bench_pallas_chained.pallas_gather``'s.

Tables: "random" (values in [0, 1)), where JAX sums a row in XLA's order and the
port left to right, so sums agree within 1e-6 relative; and "dyadic" (values
k/256 below 0.5), where every sum here is exact in float32 in any order, so the
results are bit-equal.  A chain's ``j`` depends on ``row[0]`` alone in K12 and
is exact on both.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu_torch.microbench import chained as mb_chained
from raytracer_tpu_torch.microbench import gather as mb_gather
from raytracer_tpu_torch.microbench import table_gather as mb_table_gather
from raytracer_tpu_torch.microbench import table_rowsum as mb_table_rowsum
from raytracer_tpu_torch.ops import gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the harnesses' size constants, shrunk (interpret mode runs a DMA a row)
SIZES = {
    "bench_pallas_chained": {"N": 128, "G": 64, "T": 3000, "ITERS": 4},
    "bench_vmem_gather": {"N": 512, "G": 128, "U": 300, "ITERS": 4},
    "bench_vmem_invreg": {"N": 2048, "G": 1024, "R": 1024 // 128, "ITERS": 4},
}
KINDS = ("random", "dyadic")
REL = 1e-6  # random tables: the sums' order (XLA's against left to right)


@pytest.fixture(scope="module")
def harness():
    mods = {}
    for name, consts in SIZES.items():
        spec = importlib.util.spec_from_file_location(
            f"harness_{name}", os.path.join(REPO, "scratch", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for k, v in consts.items():
            setattr(mod, k, v)
        mods[name] = mod
    return mods


def _table(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape, dtype=np.float32)
    return (rng.integers(0, 128, shape) / 256).astype(np.float32)


def _idx(rows, shape, seed):
    return np.random.default_rng(seed).integers(0, rows, shape).astype(np.int32)


def _close(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", KINDS)
def test_row_gather_matches_block_dma(harness, kind):
    """K11 against B2's ``block_kernel`` (in B3's ``pallas_gather``): exact."""
    ch = harness["bench_pallas_chained"]
    table, idx = _table(kind, (ch.T, ch.RP), 1), _idx(ch.T, ch.N, 2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ch.pallas_gather(jnp.asarray(table), jnp.asarray(idx)))
    for schedule in gather.SCHEDULES:
        np.testing.assert_array_equal(gather.row_gather(_t(table), _t(idx), schedule).numpy(),
                                      want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", [72, 128])
def test_row_gather_matches_take(kind, width):
    """K11 against B1's reference ``jnp.take`` (its ``match=``), at the walk's
    width and the padded one: exact."""
    table, idx = _table(kind, (5000, width), 3), _idx(5000, 1025, 4)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    for schedule in gather.SCHEDULES:
        np.testing.assert_array_equal(gather.row_gather(_t(table), _t(idx), schedule).numpy(),
                                      want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kernel", ["kernel_take", "kernel_tala"])
def test_row_gather_matches_vmem_kernels(harness, kernel, kind):
    """K11 direct against B4's whole-table kernels: exact."""
    vg = harness["bench_vmem_gather"]
    table, idx = _table(kind, (vg.U, vg.KP), 5), _idx(vg.U, vg.N, 6)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(vg.make_pallas(getattr(vg, kernel))(jnp.asarray(table),
                                                               jnp.asarray(idx)))
    np.testing.assert_array_equal(gather.row_gather(_t(table), _t(idx)).numpy(), want)


def _chain_inputs(ch, kind):
    return _table(kind, (ch.T, ch.RP), 7), _idx(ch.T, ch.N, 8)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("via", ["pallas_gather", "take"])
def test_chained_gather_matches_make_fn(harness, via, kind):
    """K12 against B3's ``make_fn`` checksum ``acc.sum() + j.sum()`` (float32)."""
    ch = harness["bench_pallas_chained"]
    table, idx = _chain_inputs(ch, kind)
    fn = ch.pallas_gather if via == "pallas_gather" else (lambda t, i: jnp.take(t, i, axis=0))
    with pltpu.force_tpu_interpret_mode():
        want = float(ch.make_fn(fn)(jnp.asarray(table), jnp.asarray(idx)))
    acc, j = gather.chained_gather(_t(table), _t(idx), ch.ITERS)
    got = float(acc.sum() + j.sum().to(torch.float32))
    _close(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_chained_gather_per_lane(harness, kind):
    """K12 per lane against ``make_fn``'s body with one ``pallas_gather`` call an
    iteration: ``j`` exact, ``acc`` within 1e-6 (exact on the dyadic table)."""
    ch = harness["bench_pallas_chained"]
    table, idx = _chain_inputs(ch, kind)
    tab, j_want = jnp.asarray(table), jnp.asarray(idx)
    acc_want = jnp.zeros((ch.N,), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(ch.pallas_gather)
        for i in range(ch.ITERS):
            rows = step(tab, j_want)
            acc_want = acc_want + rows.sum(axis=1)
            j_want = (j_want + (rows[:, 0] * ch.T).astype(jnp.int32) + i) % ch.T
    acc, j = gather.chained_gather(_t(table), _t(idx), ch.ITERS)
    np.testing.assert_array_equal(j.numpy(), np.asarray(j_want))
    _close(acc.numpy(), acc_want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_indep_gather_matches_indep_loop(harness, kind):
    """K12 ``indep`` against the harness's ``indep`` loop (``:107-113``, inside
    its ``main()``, so repeated here), per lane and as its checksum."""
    ch = harness["bench_pallas_chained"]
    table, idx_all = _table(kind, (ch.T, ch.RP), 9), _idx(ch.T, (ch.ITERS, ch.N), 10)

    @jax.jit
    def indep(table, idx_all):
        def body(i, acc):
            rows = jnp.take(table, idx_all[i], axis=0)
            return acc + rows.sum(axis=1)

        return jax.lax.fori_loop(0, ch.ITERS, body, jnp.zeros((ch.N,), jnp.float32))

    want = indep(jnp.asarray(table), jnp.asarray(idx_all))
    got = gather.indep_gather(_t(table), _t(idx_all))
    _close(got.numpy(), want, kind)
    _close(float(got.sum()), float(want.sum()), kind)


def _invreg_inputs(vi, kind):
    return _table(kind, (vi.C, vi.U), 11), _idx(vi.U, vi.N, 12)


@pytest.mark.parametrize("kind", KINDS)
def test_table_rowsum_matches_gather_kernel(harness, kind):
    """K13 single against B5's ``gather_kernel``."""
    vi = harness["bench_vmem_invreg"]
    tab, idx = _invreg_inputs(vi, kind)
    with pltpu.force_tpu_interpret_mode():
        want = vi.make(vi.gather_kernel)(jnp.asarray(tab), jnp.asarray(idx))
    _close(gather.table_rowsum(_t(tab), _t(idx)).numpy(), want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_table_rowsum_chain_matches_in_kernel(harness, kind):
    """K13 chained against B5's ``in_kernel`` (which returns ``acc``), and its
    ``j`` against the harness's ``loop_percall`` body (one ``gather_kernel``
    call a step, inside its ``main()``, so repeated here)."""
    vi = harness["bench_vmem_invreg"]
    tab, idx = _invreg_inputs(vi, kind)
    with pltpu.force_tpu_interpret_mode():
        acc_want = vi.make(vi.in_kernel)(jnp.asarray(tab), jnp.asarray(idx))
        gfn = vi.make(vi.gather_kernel)

        @jax.jit
        def loop_percall(table, idx):
            def body(i, carry):
                acc, j = carry
                s = gfn(table, j)
                return acc + s, (j + (s * 7.0).astype(jnp.int32) + i) % vi.U

            return jax.lax.fori_loop(0, vi.ITERS, body, (jnp.zeros((vi.N,), jnp.float32), idx))

        per_acc, j_want = loop_percall(jnp.asarray(tab), jnp.asarray(idx))
    acc, j = gather.table_rowsum_chain(_t(tab), _t(idx), vi.ITERS)
    _close(acc.numpy(), acc_want, kind)
    _close(acc.numpy(), per_acc, kind)
    np.testing.assert_array_equal(j.numpy(), np.asarray(j_want))


def test_next_index_stays_in_the_table():
    """Any step, a NaN or an infinity among them, lands in [0, t); in-range
    values step as the harnesses' ``(j + int32(x) + i) % t``."""
    x = torch.tensor([0.0, 2.9, -2.9, -7.5, 1e9, -1e9, float("nan"), float("inf"),
                      -float("inf"), 2.0**29 - 64], dtype=torch.float32)
    j = torch.full(x.shape, 3, dtype=torch.int32)
    got = gather.next_index(j, x, 2, 7)
    assert got.dtype == torch.int32
    assert got.tolist() == [5, 0, 3, 5, 5, 5, 5, 5, 5, (5 + 2**29 - 64) % 7]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    table = torch.zeros((10, 8))
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 table"):
        gather.row_gather(table.double(), idx)
    with pytest.raises(TypeError, match="int32 indices"):
        gather.row_gather(table, idx.long())
    with pytest.raises(ValueError, match="schedule"):
        gather.row_gather(table, idx, "tiled")
    with pytest.raises(TypeError, match="2-D int32 indices"):
        gather.indep_gather(table, idx)
    with pytest.raises(ValueError, match="iters"):
        gather.chained_gather(table, idx, -1)
    with pytest.raises(ValueError, match="contiguous"):
        gather.table_rowsum(table.t(), idx)


@pytest.mark.parametrize("bench,argv", [
    (mb_gather, ["--t", "3000", "--n", "700"]),
    (mb_chained, ["--t", "3000", "--n", "700", "--iters", "3"]),
    (mb_table_gather, ["--u", "300", "--n", "700", "--iters", "3"]),
    (mb_table_rowsum, ["--n", "700", "--iters", "3"]),
], ids=["gather", "chained", "table_gather", "table_rowsum"])
def test_microbench_runs_on_cpu(bench, argv, capsys):
    """Each microbenchmark's entry point with ``--cpu``: one JSON line a
    measurement, every check true, no device metric."""
    lines = bench.main(["--cpu", "--reps", "1", *argv])
    assert capsys.readouterr().out.count("\n") == len(lines) >= 4
    checks = [v for line in lines for k, v in line.items()
              if k in ("match", "exact", "j_equal", "per_call_equal")]
    assert checks and all(checks)
    assert all(line["device"] == "cpu" and line["clock"] == "host" for line in lines)
    assert all(line.get("device_ms", "not measured") == "not measured" for line in lines)
