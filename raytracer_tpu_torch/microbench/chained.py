"""Chained row gathers: 32 gathers a lane, each index depending on the row before.

The port of ``scratch/bench_pallas_chained.py``.  A ``[400000, 128]`` float32
table of values in [0, 1), 65,536 lanes; each step reads the row at ``j``, adds
its sum to ``acc`` and moves to ``j = (j + trunc(row[0] * T) + i) mod T``
(``ops/gather.next_index``).  Lines, each with ms, ns a lane-iteration and the
harness's checksum ``acc.sum() + j.sum()``:

- ``indep index_select``: the same loop over precomputed indices, the
  harness's ``indep`` baseline (``:107-113``);
- ``chained index_select``: its ``make_fn(jnp.take)``;
- ``chained K11 staged``: its ``make_fn(pallas_gather)`` (``:25``), one K11
  launch a step;
- ``K12 chained`` and ``K12 indep``: each loop as one kernel, a thread a lane.

The last line, ``agree``, says whether every chained variant ends on the same
``j`` in every lane, and how far their ``acc`` lie apart (``index_select``'s
row sums run in another order than the kernels').

    python -m raytracer_tpu_torch.microbench.chained [--cpu] [--reps 50]
"""

from __future__ import annotations

import numpy as np

from . import device_ms, device_of, emit, ms, parser

N = 1 << 16
T = 400_000
RP = 128
ITERS = 32

REPLACES = "scratch/bench_pallas_chained.py:25"


def inputs(device, n: int = N, t: int = T, iters: int = ITERS) -> tuple:
    """(table [t, 128] in [0, 1), idx [n] int32, idx_all [iters, n] int32), drawn
    in the harness's order."""
    import torch

    rng = np.random.default_rng(0)
    table = np.abs(rng.random((t, RP), np.float32))
    idx = rng.integers(0, t, n).astype(np.int32)
    idx_all = rng.integers(0, t, (iters, n)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (table, idx, idx_all))


def loop(gather_rows, table, idx, iters: int) -> tuple:
    """The harness's ``make_fn`` body: (acc, j) after ``iters`` chained steps,
    each gathering its rows with ``gather_rows(table, j)``."""
    import torch

    from ..ops.gather import next_index

    t = table.shape[0]
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=table.device)
    j = idx
    for i in range(iters):
        rows = gather_rows(table, j)
        acc = acc + rows.sum(dim=1)
        j = next_index(j, rows[:, 0] * t, i, t)
    return acc, j


def indep_loop(table, idx_all):
    """The harness's ``indep``: acc over the rows of precomputed indices."""
    import torch

    acc = torch.zeros(idx_all.shape[1:], dtype=torch.float32, device=table.device)
    for i in range(idx_all.shape[0]):
        acc = acc + torch.index_select(table, 0, idx_all[i]).sum(dim=1)
    return acc


def main(argv=None) -> list:
    ap = parser("chained row gathers (bench_pallas_chained.py)")
    ap.add_argument("--n", type=int, default=N, help="lanes")
    ap.add_argument("--t", type=int, default=T, help="table rows")
    ap.add_argument("--iters", type=int, default=ITERS, help="chained steps a lane")
    args = ap.parse_args(argv)

    import torch

    from ..ops import gather

    dev = device_of(args)
    table, idx, idx_all = inputs(dev, args.n, args.t, args.iters)
    n, iters, out = idx.shape[0], args.iters, []

    def select(tab, j):
        return torch.index_select(tab, 0, j)

    def staged(tab, j):
        return gather.row_gather(tab, j, "staged")

    def line(name, fn, checksum, **extra):
        t_ms = ms(fn, args.reps, dev)
        return emit(out, "chained", dev, name=name, ms=t_ms,
                    ns_per_lane_iter=t_ms * 1e6 / (n * iters), sum=checksum, lanes=n,
                    iters=iters, **extra)

    acc = indep_loop(table, idx_all)
    line("indep index_select", lambda: indep_loop(table, idx_all), float(acc.sum()))
    chains = {"chained index_select": (select, {}),
              "chained K11 staged": (staged, {"replaces": "scratch/bench_pallas_chained.py:60"})}
    ends = {}
    for name, (rows_of, extra) in chains.items():
        ends[name] = loop(rows_of, table, idx, iters)
        a, j = ends[name]
        line(name, lambda rows_of=rows_of: loop(rows_of, table, idx, iters),
             float(a.sum()) + float(j.sum()), **extra)

    def k12():
        return gather.chained_gather(table, idx, iters)

    def k12_indep():
        return gather.indep_gather(table, idx_all)

    ends["K12 chained"] = k12()
    a, j = ends["K12 chained"]
    line("K12 chained", k12, float(a.sum()) + float(j.sum()), replaces=REPLACES,
         device_ms=device_ms(k12, dev))
    line("K12 indep", k12_indep, float(k12_indep().sum()), device_ms=device_ms(k12_indep, dev))

    a0, j0 = ends["K12 chained"]
    emit(out, "chained", dev, name="agree",
         j_equal=all(bool(torch.equal(j, j0)) for _, j in ends.values()),
         acc_max_rel=max(float(((a - a0).abs() / a0.abs().clamp_min(1e-30)).max())
                         for a, _ in ends.values()),
         sums={k: float(a.sum()) + float(j.sum()) for k, (a, j) in ends.items()})
    return out


if __name__ == "__main__":
    main()
