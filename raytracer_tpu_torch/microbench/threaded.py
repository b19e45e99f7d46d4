"""K10, the threaded binary BVH walk (``ops/traversal.py``,
``csrc/traverse_threaded.cu``), on config3's threaded frame: its tables, the
floor of dependent row reads under it, and the kernel against the plain walk.

Renders ``config3_sponza`` (1920x1080, the 260k-triangle stand-in) once under
``traversal_kernel="threaded"`` and keeps K10's generation-0 inputs: the
primaries (closest hit) and the shadow rays of all 3 lights (any hit).  Then
one JSON line each:

- ``tables``: U (nodes), T (triangle slots), the pairs, the bytes of each table;
- ``octants``: how many active rays take each direction octant, in the TLAS's
  space and in each instance's (every active ray counted in every space);
- ``chain_floor``: K12 (``gather.chained_gather``) over the primaries' count of
  lanes x ``--iters`` dependent rows (54: K10's node visits a primary ray): the
  ``[U,6]`` box rows at their 24-byte stride with 32-bit loads (one thread a
  chain), then the same rows padded to 32 bytes with 16-byte loads (a warp
  fetches its 32 chains' rows together).  The first column picks the next
  row, so both run the same chains;
- ``walk`` (closest, any): the plain walk's node, pair and TLAS-leaf visits and
  its warp efficiency (the sum of the lanes' iterations over the sum of 32 x
  each warp's longest lane), in launch order and with the active lanes
  compacted; then the kernel's ``ms``, ``device_ms``, bytes as issued and
  sectors touched (``traffic``), held bit for bit to the plain walk.

    python -m raytracer_tpu_torch.microbench.threaded            # on the card
    python -m raytracer_tpu_torch.microbench.threaded --cpu --width 64 --height 36 \\
        --triangles 20000 --reps 1
"""

from __future__ import annotations

import numpy as np

from . import device_ms, device_of, emit, ms, parser

WIDTH, HEIGHT, TRIANGLES = 1920, 1080, 260_000
CHAIN_ITERS = 54  # K10 closest's node visits a primary ray on config3 1080p (54.4)
SECTOR = 32  # bytes of an L2 sector
# bytes a lane writes once (it reads o, d, t_max and active: 29): closest t,
# best and steps, any hit found
LANE_OUT_BYTES = {False: 12, True: 1}
# bytes one lane's loads ask for (csrc/traverse_threaded.cu): a node visit's
# record, a pair visit's row; the kernel also reads an instance's 12 matrix
# floats and its root at a TLAS-leaf entry (52), and slot 0's matrix once a
# lane (48); a BLAS exit reads the TLAS ray from shared memory
NODE_BYTES, PAIR_BYTES = 32, 80


def frame_walks(width: int, height: int, triangles: int, device):
    """(bvh, cfg, {"closest": rays, "any": rays}) of config3's threaded frame:
    K10's inputs of generation 0, each rays = (o, d, t_max, active)."""
    from ..ops import traversal
    from ..render import renderer
    from ..scene import scenes
    from ..scene.device import ScenePacker

    desc, cfg = scenes.config3_sponza(width, height, target_triangles=triangles)
    cfg = cfg.replace(traversal_kernel="threaded")
    rend = renderer.Renderer(cfg, device=device)
    scene = rend.upload(ScenePacker(desc, width, height).frame())
    kept = {}
    saved = {name: getattr(traversal, f"trace_{name}") for name in ("closest", "any")}

    def keeper(name):
        def call(bvh, o, d, t_max, active, kcfg):
            kept.setdefault(name, (bvh, kcfg, tuple(x.clone() for x in (o, d, t_max, active))))
            return saved[name](bvh, o, d, t_max, active, kcfg)
        return call

    try:
        for name in saved:
            setattr(traversal, f"trace_{name}", keeper(name))
        rend(scene)
    finally:
        for name, fn in saved.items():
            setattr(traversal, f"trace_{name}", fn)
    bvh, kcfg, _ = kept["closest"]
    return bvh, kcfg, {name: rays for name, (_, _, rays) in kept.items()}


def tables(bvh) -> dict:
    """U, T, the pairs and the bytes of each of the walk's tables."""
    return {"nodes": bvh.n_nodes, "triangles": bvh.tri.shape[0],
            "pairs": bvh.tri.shape[0] // 2, "instances": bvh.inst_mat.shape[0] - 1,
            "bytes": {name: t.numel() * t.element_size() for name, t in bvh._asdict().items()}}


def octant_use(bvh, d, active) -> dict:
    """{space: [8] counts}: the octant (bit a set <=> direction[a] > 0) of each
    active ray in the TLAS's space (slot 0, the identity) and in each
    instance's (slot k + 1)."""
    import torch

    dw = d[active]
    out = {}
    for slot in range(bvh.inst_mat.shape[0]):
        m = bvh.inst_mat[slot]
        comp = [m[4 * r] * dw[:, 0] + m[4 * r + 1] * dw[:, 1] + m[4 * r + 2] * dw[:, 2]
                for r in range(3)]
        oct_ = (comp[0] > 0).long() | ((comp[1] > 0).long() << 1) | ((comp[2] > 0).long() << 2)
        out["tlas" if slot == 0 else f"instance_{slot - 1}"] = \
            torch.bincount(oct_, minlength=8).tolist()
    return out


def warp_efficiency(iterations) -> float:
    """Sum of per-lane iterations over the sum, over warps of 32 consecutive
    lanes, of 32 x the warp's longest lane: the share of lane slots a warp's
    loop keeps busy (1 when every lane of every warp runs as long)."""
    import torch

    n = iterations.shape[0]
    if n == 0:
        return 1.0
    it = torch.nn.functional.pad(iterations.to(torch.int64), (0, (-n) % 32)).view(-1, 32)
    busy = int(it.amax(dim=1).sum()) * 32
    return int(it.sum()) / busy if busy else 1.0


def sectors(offsets, length: int):
    """32-byte sectors that ``length`` bytes at each byte offset touch."""
    return (offsets + length - 1) // SECTOR - offsets // SECTOR + 1


def traffic(walk, lanes: int, any_hit: bool) -> dict:
    """Bytes as issued and sectors touched by one kernel launch on the walk's
    rays: per lane-visit, as if no two lanes shared a load (tables from
    32-byte aligned bases), from the plain walk's visits of each node and pair
    (``trace_plain(..., visits=True)``); each lane's own inputs and outputs
    once."""
    import torch

    nodes, pairs = walk.node_hist, walk.pair_hist
    entries = int(walk.entries.sum())
    active = int((walk.steps > 0).sum())
    lane_bytes = lanes * (12 + 12 + 4 + 1 + LANE_OUT_BYTES[any_hit])
    p = torch.arange(pairs.shape[0], device=pairs.device, dtype=torch.int64)
    n_nodes, n_pairs = int(nodes.sum()), int(pairs.sum())
    node_sec = n_nodes  # a record is one 32-byte aligned sector
    pair_sec = int((pairs * sectors(PAIR_BYTES * p, PAIR_BYTES)).sum())
    # an instance's 48-byte matrix row touches 2 sectors, its root 1; every
    # active lane transforms its ray through slot 0 once at the start
    enter_sec = entries * 3 + active * 2
    issued = (lane_bytes + n_nodes * NODE_BYTES + n_pairs * PAIR_BYTES + entries * 52
              + active * 48)
    return {"bytes_as_issued": issued,
            "sectors_touched": node_sec + pair_sec + enter_sec + -(-lane_bytes // SECTOR),
            "node_sectors": node_sec, "pair_sectors": pair_sec}


def chain_floor(bvh, lanes: int, iters: int, device, reps: int) -> list:
    """K12 over the box rows as they are and padded to 32 bytes (see the module
    docstring): per table {rows, ms, device_ms, bytes as issued, their rate,
    sectors touched, exact}."""
    import torch

    from ..ops import gather

    box = bvh.box.contiguous()
    u = box.shape[0]
    padded = torch.cat([box, torch.zeros((u, 2), dtype=box.dtype, device=box.device)],
                       dim=1).contiguous()
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, u, lanes).astype(np.int32)).to(
        box.device)
    out = []
    for label, table, loads in (("box_rows_24B", box, "scalar"), ("rows_32B", padded, "vector")):
        want = gather.chained_gather_plain(table, idx, iters)
        row = table.shape[1] * 4
        sec, j = 0, idx
        for i in range(iters):  # the rows each chain reads, as the kernel does
            sec += int(sectors(j.long() * row, row).sum())
            j = gather.next_index(j, table[j.long(), 0] * u, i, u)

        def run(t=table, ld=loads):
            return gather.chained_gather(t, idx, iters, ld)

        exact = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                    for a, b in zip(run(), want))
        dev_ms = device_ms(run, device, reps)
        out.append({"table": label, "shape": list(table.shape), "loads": loads,
                    "lanes": lanes, "iters": iters, "exact": exact,
                    "ms": ms(run, reps, device), "device_ms": dev_ms,
                    "bytes_as_issued": lanes * iters * row,
                    "issued_per_s": (lanes * iters * row / (dev_ms / 1e3)
                                     if isinstance(dev_ms, float) else "not measured"),
                    "sectors_touched": sec})
    return out


def measure_walk(name: str, bvh, kcfg, rays, device, reps: int) -> dict:
    """The plain walk's counts and warp efficiency on ``rays``, and on the card
    the kernel's times, traffic and whether it equals the plain walk."""
    import torch

    from ..config import TraversalStrategy
    from ..ops import traversal

    any_hit = name == "any"
    o, d, t_max, active = rays
    ordered = kcfg.traversal_strategy == TraversalStrategy.ORDERED
    walk = traversal.trace_plain(bvh, o, d, t_max, active, ordered, any_hit, visits=True)
    iters = walk.steps + walk.pairs
    line = {"walk": name, "lanes": o.shape[0], "active": int(active.sum()),
            "node_visits": int(walk.steps.sum()), "pair_visits": int(walk.pairs.sum()),
            "entries": int(walk.entries.sum()),
            "warp_efficiency": warp_efficiency(iters),
            "warp_efficiency_compacted": warp_efficiency(iters[active])}
    if device.type != "cuda":
        return line

    def run():
        return traversal._launch(any_hit, bvh, o, d, t_max, active, kcfg)
    t, best, steps, found, inc = run()
    if any_hit:
        same = bool(torch.equal(found, walk.found))
    else:
        same = bool(torch.equal(best, walk.best) and torch.equal(steps, walk.steps)
                    and torch.equal(t.view(torch.int32), walk.t.view(torch.int32)))
    line["kernel"] = {"exact": same and int(inc) == 0, "ms": ms(run, reps, device),
                      "device_ms": device_ms(run, device, reps),
                      **traffic(walk, o.shape[0], any_hit)}
    return line


def main(argv=None) -> list:
    ap = parser("K10's tables, floor and walk on config3's threaded frame.")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--triangles", type=int, default=TRIANGLES)
    ap.add_argument("--iters", type=int, default=CHAIN_ITERS, help="K12 rows a lane")
    args = ap.parse_args(argv)
    device = device_of(args)
    out = []
    if device.type == "cuda":
        from .. import kernels

        built = kernels.build(force=True, verbose_ptxas=True)
        emit(out, "build", device, seconds=built["traverse_threaded"]["seconds"],
             ptxas=kernels.ptxas_usage(built["traverse_threaded"]["log"]))
    bvh, kcfg, walks = frame_walks(args.width, args.height, args.triangles, device)
    emit(out, "tables", device, **tables(bvh))
    emit(out, "octants", device, **{name: octant_use(bvh, rays[1], rays[3])
                                    for name, rays in walks.items()})
    for row in chain_floor(bvh, walks["closest"][0].shape[0], args.iters, device, args.reps):
        emit(out, "chain_floor", device, **row)
    for name in ("closest", "any"):
        emit(out, "walk", device, **measure_walk(name, bvh, kcfg, walks[name], device,
                                                 args.reps))
    return out


if __name__ == "__main__":
    main()
