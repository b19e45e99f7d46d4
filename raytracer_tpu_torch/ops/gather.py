"""Row gathers from a float32 table, independent and chained: kernels K11-K13.

The counterparts of the Pallas kernels of the row-gather harnesses in
``scratch/`` (``bench_pallas_gather.py``, ``bench_pallas_chained.py``,
``bench_vmem_gather.py``, ``bench_vmem_invreg.py``), which time row gathers at
the wide walk's row (72 float32, 288 B, one K1 node visit): independent, and
chained so that the next index depends on the row just read.

- K11 ``row_gather``: ``out[n] = table[idx[n]]``, a copy of bits.  Two
  schedules: ``"direct"`` (each thread one 16-byte piece of a row) and
  ``"staged"`` (stages of 16 consecutive indices stream their rows through a
  ring of 8 stages in shared memory, one bulk async copy a row, each stage
  completing on its own mbarrier; persistent blocks, as many as fit the card).
- K12 ``chained_gather``: per lane, ``iters`` dependent row reads, each row
  summed left to right into ``acc`` and its first column choosing the next row;
  ``indep_gather`` is the same loop over precomputed indices.  A warp fetches
  its 32 lanes' rows together into shared memory, each 16-byte copy
  instruction reading 32 consecutive pieces.
- K13 ``table_rowsum`` / ``table_rowsum_chain``: the sum of a record stored in a
  column of a small ``[C, U]`` table, once or chained as K12.  One block an SM
  stages the table once, in its own ``[C][U]`` layout.

CPU tensors take the ``*_plain`` versions.  CUDA tensors launch
``csrc/gather.cu`` (counted in ``trace.counters[LAUNCH[kind]]``) or raise.
Indices must lie in the table; they do in every harness by construction, and
the kernels do not clamp them.  The next index of a chain always does: see
``next_index``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import trace

# the counter key of csrc/gather.cu's launches of each kind: K11 direct and
# staged, K12 chained and indep, K13 single and chained
LAUNCH = {"direct": "launch.k11.direct", "staged": "launch.k11.staged",
          "chained": "launch.k12.chained", "indep": "launch.k12.indep",
          "rowsum": "launch.k13.rowsum", "rowsum_chain": "launch.k13.rowsum_chain"}

SCHEDULES = ("direct", "staged")
K13_SCALE = 7.0  # K13's next index: trunc(s * 7) (bench_vmem_invreg.py:54)
_RING_ROWS = 8 * 16  # K11 staged's ring: kRingStages x kRingRows rows (csrc/gather.cu)
# shared memory a block may opt in to on the H100 (232,448 B), less 1 KB for the
# ring's barriers: rows of at most 1,808 B (452 floats) fit the ring
_RING_SMEM_LIMIT = 232_448 - 1024
_SMEM_LIMIT = 48 * 1024  # K13: shared memory a block may use without opting in
# K12: a slot of 32 rows of (R/4 | 1) 16-byte pieces a warp, within the
# opt-in shared memory less 1 KB (csrc/gather.cu kSmemOptIn): rows of at most
# 1,804 floats
_WARP_ROW_PIECES = 451
_STEP_LIMIT = 1 << 29  # a chain's step trunc(x) counts only for |x| below it (next_index)
_ROWS_LIMIT = 1 << 30  # rows of a chained table, so that j + step + i fits int32


def next_index(j: torch.Tensor, x: torch.Tensor, i: int, t: int) -> torch.Tensor:
    """A chain's next row: ``(j + trunc_int32(x) + i) mod t``, the harnesses' update
    (``bench_pallas_chained.py:80``, ``bench_vmem_invreg.py:54``).  ``x`` outside
    +-2^29 (a NaN or an infinity among them) steps by 0, and the modulus takes the
    divisor's sign (``jnp`` ``%``), so the result lies in ``[0, t)`` for any table;
    on the harnesses' tables (values in [0, 1)) neither rule ever applies."""
    k = torch.where(x.abs() < _STEP_LIMIT, x, torch.zeros_like(x)).to(torch.int32)
    return torch.remainder(j + k + i, t)


def _sum_left_to_right(cols) -> torch.Tensor:
    """float32 sum of the columns in order, c = 0 first: the kernels' order."""
    s = cols[0]
    for c in cols[1:]:
        s = s + c
    return s


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K11 in torch: ``table[idx]``."""
    return table[idx.long()]


def chained_gather_plain(table: torch.Tensor, idx0: torch.Tensor, iters: int) -> tuple:
    """K12 in torch: (acc [N] f32, j [N] int32) after ``iters`` steps of
    ``row = table[j]; acc += sum(row); j = next_index(j, row[0] * T, i, T)``."""
    t = table.shape[0]
    acc = torch.zeros(idx0.shape, dtype=torch.float32, device=table.device)
    j = idx0
    for i in range(iters):
        rows = table[j.long()]
        acc = acc + _sum_left_to_right(rows.unbind(1))
        j = next_index(j, rows[:, 0] * t, i, t)
    return acc, j


def indep_gather_plain(table: torch.Tensor, idx_all: torch.Tensor) -> torch.Tensor:
    """K12's ``indep`` mode in torch: ``acc [N]`` summed over the rows
    ``table[idx_all[i]]``, i = 0 .. iters-1."""
    acc = torch.zeros(idx_all.shape[1:], dtype=torch.float32, device=table.device)
    for i in range(idx_all.shape[0]):
        acc = acc + _sum_left_to_right(table[idx_all[i].long()].unbind(1))
    return acc


def table_rowsum_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K13 single in torch: ``out[n] = sum_c tab[c, idx[n]]``, c = 0 first."""
    return _sum_left_to_right(tab[:, idx.long()].unbind(0))


def table_rowsum_chain_plain(tab: torch.Tensor, idx0: torch.Tensor, iters: int) -> tuple:
    """K13 chained in torch: (acc, j) after ``iters`` steps of
    ``s = sum_c tab[c, j]; acc += s; j = next_index(j, s * 7, i, U)``."""
    u = tab.shape[1]
    acc = torch.zeros(idx0.shape, dtype=torch.float32, device=tab.device)
    j = idx0
    for i in range(iters):
        s = table_rowsum_plain(tab, j)
        acc = acc + s
        j = next_index(j, s * K13_SCALE, i, u)
    return acc, j


def _check(what: str, table: torch.Tensor, idx: torch.Tensor, idx_dims: int) -> None:
    """Both devices: a 2-D float32 table, int32 indices of ``idx_dims`` dimensions,
    on one device (the CPU or a CUDA card), contiguous."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: CPU or CUDA tensors expected")
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"{what}: a 2-D float32 table expected")
    if idx.dim() != idx_dims or idx.dtype != torch.int32:
        raise TypeError(f"{what}: {idx_dims}-D int32 indices expected")
    if idx.device != table.device:
        raise ValueError(f"{what}: table and indices on different devices")
    kernels.require_contiguous(what, table, idx)


def _check_rows(what: str, table: torch.Tensor) -> int:
    """Before a K11 or K12 launch: rows of whole 16-byte pieces from a 16-byte
    aligned base, as the 16-byte loads and ``cp.async`` need; returns the pieces
    a row."""
    if table.shape[1] % 4 or table.data_ptr() % 16:
        raise ValueError(f"{what}: rows of a multiple of 4 floats from a 16-byte aligned "
                         "base expected")
    return table.shape[1] // 4


def _iters(what: str, iters: int, rows: int) -> int:
    """A chain's bounds, under which ``j + step + i`` never leaves int32."""
    if not 0 <= iters < _STEP_LIMIT or not 0 < rows < _ROWS_LIMIT:
        raise ValueError(f"{what}: 0 <= iters < 2^29 and 1 <= rows < 2^30 expected")
    return int(iters)


def row_gather(table: torch.Tensor, idx: torch.Tensor, schedule: str = "direct") -> torch.Tensor:
    """K11: ``table[idx]``, [T, R] f32 and [N] int32 -> [N, R].  CPU tensors take
    ``row_gather_plain``; CUDA tensors launch ``rt_row_gather`` under
    ``schedule`` (``"direct"`` or ``"staged"``, counted under ``LAUNCH``); the
    staged ring holds rows of at most 452 floats."""
    _check("row_gather", table, idx, 1)
    if schedule not in SCHEDULES:
        raise ValueError(f"row_gather: schedule must be one of {SCHEDULES}")
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    r4 = _check_rows("row_gather", table)
    n = idx.shape[0]
    if n * r4 >= 2**31:
        raise ValueError("row_gather: N * R / 4 < 2^31 expected")
    if schedule == "staged" and 16 * r4 * _RING_ROWS > _RING_SMEM_LIMIT:
        raise ValueError("row_gather: the staged ring holds rows of at most 452 floats")
    out = torch.empty((n, table.shape[1]), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    fn = kernels.entry("gather", "rt_row_gather",
                       [kernels.I, kernels.P, kernels.I, kernels.P, kernels.I, kernels.P,
                        kernels.P])
    err = fn(int(schedule == "staged"), table.data_ptr(), r4, idx.data_ptr(), n,
             out.data_ptr(), kernels.stream_ptr(table.device))
    trace.count(LAUNCH[schedule])
    kernels.check(err, f"rt_row_gather ({schedule})")
    return out


def _launch_chain(indep: bool, table, idx, n, iters, acc, j_out) -> None:
    r4 = _check_rows("chained_gather", table)
    if r4 > _WARP_ROW_PIECES:
        raise ValueError("chained_gather: a warp's slot holds rows of at most 1804 floats")
    fn = kernels.entry("gather", "rt_chained_gather",
                       [kernels.I, kernels.P, kernels.I, kernels.I, kernels.P, kernels.I,
                        kernels.I, kernels.P, kernels.P, kernels.P])
    err = fn(int(indep), table.data_ptr(), table.shape[0], r4, idx.data_ptr(), n, iters,
             acc.data_ptr(), None if j_out is None else j_out.data_ptr(),
             kernels.stream_ptr(table.device))
    trace.count(LAUNCH["indep" if indep else "chained"])
    kernels.check(err, "rt_chained_gather")


def chained_gather(table: torch.Tensor, idx0: torch.Tensor, iters: int,
                   loads: str = "vector") -> tuple:
    """K12: (acc [N] f32, j [N] int32) of ``chained_gather_plain``.  CPU tensors
    take the plain version; CUDA tensors launch ``rt_chained_gather``
    (``loads="vector"``: 16-byte loads of rows of whole 16-byte pieces) or
    ``rt_chained_gather_scalar`` (``"scalar"``: 32-bit loads of rows of any
    width, one thread a chain), counted under ``LAUNCH["chained"]``."""
    _check("chained_gather", table, idx0, 1)
    iters = _iters("chained_gather", iters, table.shape[0])
    if loads not in ("vector", "scalar"):
        raise ValueError("chained_gather: loads must be 'vector' or 'scalar'")
    if table.device.type == "cpu":
        return chained_gather_plain(table, idx0, iters)
    n = idx0.shape[0]
    acc = torch.empty((n,), dtype=torch.float32, device=table.device)
    j = torch.empty_like(idx0)
    if n and loads == "scalar":
        fn = kernels.entry("gather", "rt_chained_gather_scalar",
                           [kernels.P, kernels.I, kernels.I, kernels.P, kernels.I, kernels.I,
                            kernels.P, kernels.P, kernels.P])
        err = fn(table.data_ptr(), table.shape[0], table.shape[1], idx0.data_ptr(), n, iters,
                 acc.data_ptr(), j.data_ptr(), kernels.stream_ptr(table.device))
        trace.count(LAUNCH["chained"])
        kernels.check(err, "rt_chained_gather_scalar")
    elif n:
        _launch_chain(False, table, idx0, n, iters, acc, j)
    return acc, j


def indep_gather(table: torch.Tensor, idx_all: torch.Tensor) -> torch.Tensor:
    """K12's ``indep`` mode: ``indep_gather_plain``'s acc over ``idx_all
    [iters, N]``.  CUDA tensors launch ``rt_chained_gather`` (counted under
    ``LAUNCH["indep"]``)."""
    _check("indep_gather", table, idx_all, 2)
    if table.device.type == "cpu":
        return indep_gather_plain(table, idx_all)
    iters, n = idx_all.shape
    _iters("indep_gather", iters, table.shape[0])
    acc = torch.empty((n,), dtype=torch.float32, device=table.device)
    if n:
        _launch_chain(True, table, idx_all, n, iters, acc, None)
    return acc


def _launch_rowsum(tab, idx, n, iters, acc, j_out) -> None:
    c, u = tab.shape
    if u * (c | 1) * 4 > _SMEM_LIMIT:
        raise ValueError("table_rowsum: the table must fit 48 KB of shared memory "
                         "with a row of padding")
    fn = kernels.entry("gather", "rt_table_rowsum",
                       [kernels.P, kernels.I, kernels.I, kernels.P, kernels.I, kernels.I,
                        kernels.P, kernels.P, kernels.P])
    err = fn(tab.data_ptr(), c, u, idx.data_ptr(), n, iters, acc.data_ptr(),
             None if j_out is None else j_out.data_ptr(), kernels.stream_ptr(tab.device))
    trace.count(LAUNCH["rowsum_chain" if j_out is not None else "rowsum"])
    kernels.check(err, "rt_table_rowsum")


def table_rowsum(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K13 single: ``table_rowsum_plain`` of a [C, U] f32 table (records in
    columns).  CUDA tensors launch ``rt_table_rowsum``, counted under
    ``LAUNCH["rowsum"]``."""
    _check("table_rowsum", tab, idx, 1)
    if tab.device.type == "cpu":
        return table_rowsum_plain(tab, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=tab.device)
    if idx.shape[0]:
        _launch_rowsum(tab, idx, idx.shape[0], 1, out, None)
    return out


def table_rowsum_chain(tab: torch.Tensor, idx0: torch.Tensor, iters: int) -> tuple:
    """K13 chained: (acc, j) of ``table_rowsum_chain_plain``.  CUDA tensors
    launch ``rt_table_rowsum``, counted under ``LAUNCH["rowsum_chain"]``."""
    _check("table_rowsum_chain", tab, idx0, 1)
    iters = _iters("table_rowsum_chain", iters, tab.shape[1])
    if tab.device.type == "cpu":
        return table_rowsum_chain_plain(tab, idx0, iters)
    n = idx0.shape[0]
    acc = torch.empty((n,), dtype=torch.float32, device=tab.device)
    j = torch.empty_like(idx0)
    if n:
        _launch_rowsum(tab, idx0, n, iters, acc, j)
    return acc, j
