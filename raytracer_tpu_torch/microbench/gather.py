"""Independent row gathers, K11 direct and staged against ``torch.index_select``.

The port of ``scratch/bench_pallas_gather.py``: a ``[400000, 72]`` float32 table
(the wide walk's Sponza-class table) and its copy zero-padded to 128 columns
(the width the harness's Pallas kernels need), 65,536 random rows gathered.

- ``index_select [T,72]`` and ``[T,128]``: the harness's ``jnp.take`` lines;
- ``K11 direct [T,128]``: its ``row_kernel`` (one row a grid step, ``:63``);
- ``K11 staged [T,128]``: its ``block_kernel`` (G rows a grid step through a
  2-deep DMA ring, ``:92``);
- both schedules on the unpadded ``[T,72]`` table, which the port takes as is.

Each line: ms, ns a lane, and whether the rows equal ``index_select``'s.

    python -m raytracer_tpu_torch.microbench.gather [--cpu] [--reps 50]
"""

from __future__ import annotations

import numpy as np

from . import device_ms, device_of, emit, ms, parser

T = 400_000  # table rows
R = 72  # row width, floats
RP = 128  # the harness's padded width
N = 1 << 16  # gathered lanes

REPLACES = {"direct": "scratch/bench_pallas_gather.py:63", "staged": "scratch/bench_pallas_gather.py:92"}


def inputs(device, t: int = T, n: int = N) -> tuple:
    """(table [t, 72], table padded to [t, 128], idx [n] int32) on ``device``."""
    import torch

    rng = np.random.default_rng(0)
    table = rng.standard_normal((t, R), dtype=np.float32)
    padded = np.pad(table, ((0, 0), (0, RP - R)))
    idx = rng.integers(0, t, n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (table, padded, idx))


def main(argv=None) -> list:
    ap = parser("K11 row gathers against torch.index_select (bench_pallas_gather.py)")
    ap.add_argument("--t", type=int, default=T, help="table rows")
    ap.add_argument("--n", type=int, default=N, help="gathered lanes")
    args = ap.parse_args(argv)

    import torch

    from ..ops import gather

    dev = device_of(args)
    table, padded, idx = inputs(dev, args.t, args.n)
    n, out = idx.shape[0], []

    refs = {}
    for label, tab in (("[T,72]", table), ("[T,128]", padded)):
        refs[label] = torch.index_select(tab, 0, idx)
        t_ms = ms(lambda tab=tab: torch.index_select(tab, 0, idx), args.reps, dev)
        emit(out, "gather", dev, name=f"index_select {label}", ms=t_ms, ns_per_lane=t_ms * 1e6 / n,
             lanes=n)
    for label, tab in (("[T,128]", padded), ("[T,72]", table)):
        for schedule in gather.SCHEDULES:
            def fn(tab=tab, schedule=schedule):
                return gather.row_gather(tab, idx, schedule)

            t_ms = ms(fn, args.reps, dev)
            emit(out, "gather", dev, name=f"K11 {schedule} {label}", replaces=REPLACES[schedule],
                 ms=t_ms, ns_per_lane=t_ms * 1e6 / n, device_ms=device_ms(fn, dev),
                 match=bool(torch.equal(fn(), refs[label])), lanes=n)
    return out


if __name__ == "__main__":
    main()
