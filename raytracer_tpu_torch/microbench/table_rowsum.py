"""Record sums from a ``[72, 128]`` table, once and in a chain inside the kernel.

The port of ``scratch/bench_vmem_invreg.py``: 128 records of 72 components
stored in columns (36 KB), 131,072 lanes, each reading ``s = sum_c tab[c, j]``.
The chain (32 steps) moves to ``j = (j + trunc(s * 7) + i) mod 128``.  Lines:

- ``K13 single``: its ``gather_kernel`` (``:63``) as K13 (one block an SM
  stages the table once), against ``index_select(tab.T).sum(1)`` (another
  order of the sum) and exactly against the plain version;
- ``per-call K13 single``: the chain with one K13 launch a step (its
  ``loop_percall``);
- ``K13 chained``: the whole chain in one kernel (its ``in_kernel``, ``:39``);
- ``index_select``: its XLA ``take`` baseline loop over the transposed table;
- ``bank_conflicts``: for single and chained, the shared-memory wavefronts a
  warp's record reads take in K13's ``[C][U]`` table, over the count
  without conflicts (``bank_conflicts``, computed from the records the lanes
  read, on either device).

Each chain line: ms, ns a lane-iteration, the checksum ``acc.sum() + j.sum()``.

    python -m raytracer_tpu_torch.microbench.table_rowsum [--cpu] [--reps 50]
"""

from __future__ import annotations

import numpy as np

from . import device_ms, device_of, emit, ms, parser

N = 1 << 17
C = 72  # record components (the table's rows)
U = 128  # records (its columns)
ITERS = 32


def inputs(device, n: int = N) -> tuple:
    """(tab [72, 128] in [0, 1), idx [n] int32 in [0, 128))."""
    import torch

    rng = np.random.default_rng(0)
    tab = rng.random((C, U), np.float32)
    idx = rng.integers(0, U, n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (tab, idx))


def chain(record_sums, tab, idx, iters: int) -> tuple:
    """(acc, j) after ``iters`` steps, each record's sum from ``record_sums(j)``."""
    import torch

    from ..ops.gather import K13_SCALE, next_index

    acc = torch.zeros(idx.shape, dtype=torch.float32, device=tab.device)
    j = idx
    for i in range(iters):
        s = record_sums(j)
        acc = acc + s
        j = next_index(j, s * K13_SCALE, i, tab.shape[1])
    return acc, j


def record_steps(tab, idx, iters: int):
    """[iters, n] int32: the record each lane reads at each step of the chain."""
    import torch

    from ..ops.gather import K13_SCALE, next_index, table_rowsum_plain

    steps, j = [], idx
    for i in range(iters):
        steps.append(j)
        j = next_index(j, table_rowsum_plain(tab, j) * K13_SCALE, i, tab.shape[1])
    return torch.stack(steps)


def bank_conflicts(records) -> float:
    """Shared-memory wavefronts that warps of 32 consecutive lanes take to read
    their records (``records`` [steps, n], n a multiple of 32) from a ``[C][U]``
    table, over the count without conflicts.

    A 4-byte read takes as many wavefronts as the most distinct words that
    fall in one of 32 banks (1 without conflicts).  Component c of record j
    lies at word c U + j, which shifts all lanes' banks alike, so one
    component's count holds for all: the count is taken at component 0, where
    record j's bank is j mod 32."""
    import torch

    words = records.reshape(-1, 32).long().sort(dim=1).values
    distinct = torch.ones_like(words)
    distinct[:, 1:] = (words[:, 1:] != words[:, :-1]).long()
    per_bank = torch.zeros((words.shape[0], 32), dtype=torch.int64, device=words.device)
    per_bank.scatter_add_(1, words % 32, distinct)
    return float(per_bank.amax(1).double().mean())  # 1 without conflicts


def main(argv=None) -> list:
    ap = parser("record sums from a [72, 128] table (bench_vmem_invreg.py)")
    ap.add_argument("--n", type=int, default=N, help="lanes")
    ap.add_argument("--iters", type=int, default=ITERS, help="chained steps a lane")
    args = ap.parse_args(argv)

    import torch

    from ..ops import gather

    dev = device_of(args)
    tab, idx = inputs(dev, args.n)
    tab_t = tab.t().contiguous()
    n, iters, out = idx.shape[0], args.iters, []

    def single():
        return gather.table_rowsum(tab, idx)

    got = single()
    t_ms = ms(single, args.reps, dev)
    emit(out, "table_rowsum", dev, name="K13 single", replaces="scratch/bench_vmem_invreg.py:63",
         ms=t_ms, ns_per_lane=t_ms * 1e6 / n, device_ms=device_ms(single, dev),
         sum=float(got.sum()),
         max_abs_err_vs_index_select=float(
             (got - torch.index_select(tab_t, 0, idx).sum(dim=1)).abs().max()),
         exact=bool(torch.equal(got, gather.table_rowsum_plain(tab, idx))), lanes=n)

    def chain_line(name, fn, **extra):
        acc, j = fn()
        t_ms = ms(fn, args.reps, dev)
        emit(out, "table_rowsum", dev, name=name, ms=t_ms,
             ns_per_lane_iter=t_ms * 1e6 / (n * iters), sum=float(acc.sum()) + float(j.sum()),
             lanes=n, iters=iters, **extra)
        return acc, j

    per_call = chain_line("per-call K13 single",
                          lambda: chain(lambda j: gather.table_rowsum(tab, j), tab, idx, iters))

    def k13():
        return gather.table_rowsum_chain(tab, idx, iters)

    acc, j = chain_line("K13 chained", k13, replaces="scratch/bench_vmem_invreg.py:39",
                        device_ms=device_ms(k13, dev))
    emit(out, "table_rowsum", dev, name="agree",
         per_call_equal=bool(torch.equal(acc, per_call[0]) and torch.equal(j, per_call[1])))
    chain_line("index_select", lambda: chain(
        lambda j: torch.index_select(tab_t, 0, j).sum(dim=1), tab, idx, iters))
    for mode, records in (("single", idx[None]), ("chained", record_steps(tab, idx, iters))):
        emit(out, "table_rowsum", dev, name="bank_conflicts", mode=mode,
             over_conflict_free=bank_conflicts(records[:, :n - n % 32]),
             distinct_records_a_warp=float(
                 (records[:, :n - n % 32].reshape(-1, 32).sort(1).values.diff(dim=1) != 0)
                 .sum(1).add(1).float().mean()))
    return out


if __name__ == "__main__":
    main()
