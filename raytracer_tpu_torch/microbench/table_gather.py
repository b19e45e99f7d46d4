"""Row gathers from a 2.40 MB table, once and chained.

The port of ``scratch/bench_vmem_gather.py``, whose Pallas kernels gather from a
``[4680, 128]`` float32 table held whole in the TPU's VMEM (``kernel_take``
``:33`` by ``jnp.take``, ``kernel_tala`` ``:37`` by ``take_along_axis``; the
same function).  A block of this card holds at most 227 KB of shared memory, so
the table lives in the 50 MB L2 and K11 direct serves both.  131,072 lanes; the
chained loop is ``bench_loop``'s (``:61-75``): 32 steps of
``j = (j + trunc(row[0] * U) + i) mod U``.  Lines:

- ``chained index_select``: the harness's ``jnp.take`` baseline loop;
- ``K11 direct``: one gather, exact against ``index_select``;
- ``chained K11 direct``: ``bench_loop`` over the kernel, one launch a step;
- ``K12 chained``: the loop as one kernel (its ``j`` against the others').

    python -m raytracer_tpu_torch.microbench.table_gather [--cpu] [--reps 50]
"""

from __future__ import annotations

import numpy as np

from . import device_ms, device_of, emit, ms, parser
from .chained import loop

N = 1 << 17
KP = 128  # row width
U = 4680  # table rows: 4680 x 128 x 4 B = 2.40 MB
ITERS = 32

REPLACES = "scratch/bench_vmem_gather.py:33"  # and :37 kernel_tala


def inputs(device, n: int = N, u: int = U) -> tuple:
    """(table [u, 128] in [0, 1), idx [n] int32)."""
    import torch

    rng = np.random.default_rng(0)
    table = rng.random((u, KP), np.float32)
    idx = rng.integers(0, u, n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (table, idx))


def main(argv=None) -> list:
    ap = parser("row gathers from a 2.40 MB table (bench_vmem_gather.py)")
    ap.add_argument("--n", type=int, default=N, help="lanes")
    ap.add_argument("--u", type=int, default=U, help="table rows")
    ap.add_argument("--iters", type=int, default=ITERS, help="chained steps a lane")
    args = ap.parse_args(argv)

    import torch

    from ..ops import gather

    dev = device_of(args)
    table, idx = inputs(dev, args.n, args.u)
    n, iters, out = idx.shape[0], args.iters, []

    def select(tab, j):
        return torch.index_select(tab, 0, j)

    def direct(tab, j):
        return gather.row_gather(tab, j, "direct")

    def chain_line(name, rows_of, **extra):
        acc, j = loop(rows_of, table, idx, iters)
        t_ms = ms(lambda: loop(rows_of, table, idx, iters), args.reps, dev)
        emit(out, "table_gather", dev, name=name, ms=t_ms,
             ns_per_lane_iter=t_ms * 1e6 / (n * iters), sum=float(acc.sum()) + float(j.sum()),
             lanes=n, iters=iters, **extra)
        return j

    j_ref = chain_line("chained index_select", select)

    def one():
        return direct(table, idx)

    t_ms = ms(one, args.reps, dev)
    emit(out, "table_gather", dev, name="K11 direct", replaces=REPLACES, ms=t_ms,
         ns_per_lane=t_ms * 1e6 / n, device_ms=device_ms(one, dev),
         exact=bool(torch.equal(one(), torch.index_select(table, 0, idx))), lanes=n)
    j_k11 = chain_line("chained K11 direct", direct)

    def k12():
        return gather.chained_gather(table, idx, iters)

    acc, j = k12()
    t_ms = ms(k12, args.reps, dev)
    emit(out, "table_gather", dev, name="K12 chained", replaces="scratch/bench_vmem_gather.py:61",
         ms=t_ms, ns_per_lane_iter=t_ms * 1e6 / (n * iters), device_ms=device_ms(k12, dev),
         sum=float(acc.sum()) + float(j.sum()),
         j_equal=bool(torch.equal(j, j_ref) and torch.equal(j_k11, j_ref)), lanes=n, iters=iters)
    return out


if __name__ == "__main__":
    main()
