"""K10's record tables (``ops/traversal.py``: ``octant_records``,
``pair_rows``), which ``csrc/traverse_threaded.cu``'s rec_kernel reads: they
decode back to the split tables bit for bit, a plain walk over the decoded
tables alone equals ``trace_plain`` on config3-tiny's and config4-tiny's
primaries and shadow rays (ORDERED and NAIVE), and the packers refuse values
beyond their bits.  The kernel is held to the plain walk on the card
(``test_torch_kernels_gpu.py``)."""

import functools

import pytest
import torch

from raytracer_tpu_torch.config import TraversalStrategy
from raytracer_tpu_torch.ops import traversal
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import scenes
from raytracer_tpu_torch.scene.device import ScenePacker
from torch_parity import jax_scene, private_bvh_cache, torch_config, torch_scene

CONFIG4_TINY = (48, 32)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(port scene, port config) of config3-tiny (the JAX package's packing) or
    config4-tiny (the port's, rotated instances and an axis-aligned light)."""
    if name == "config3":
        scene, cfg = jax_scene("config3")
        return torch_scene(scene), torch_config(cfg)
    with private_bvh_cache():
        desc, cfg = scenes.make_scene("config4")
        cfg = cfg.replace(width=CONFIG4_TINY[0], height=CONFIG4_TINY[1])
        rend = renderer.Renderer(cfg, device="cpu")
        return rend.upload(ScenePacker(desc, *CONFIG4_TINY).frame()), cfg


@functools.lru_cache(maxsize=None)
def _bvh(name):
    return traversal.build_scene_bvh(_scene(name)[0])


def _decode(bvh):
    """(box, node, links, tri) read back from the octant records and the pair
    rows alone.  The records do not keep a leaf's near link (the walk never
    follows it; its word holds the payload): those come back as -1."""
    u = bvh.n_nodes
    tri = bvh.pairs[:, :18].reshape(-1, 9)
    r = bvh.rec.view(8, u, 8)
    box = r[0, :, :6].contiguous().view(torch.float32)
    near, skip = r[..., 6], r[..., 7]
    leaf = near[0] < 0
    tlas = leaf & ((near[0] & traversal.TLAS_BIT) != 0)
    blas = leaf & ~tlas
    payload = near[0]
    left = torch.where(tlas, payload & 0xFF, (payload & ((1 << 21) - 1)) << 1)
    count = torch.where(tlas, (payload >> 8) & ((1 << 21) - 1), ((payload >> 21) & 0x1FF) << 1)
    # an internal node's left child is its near child in octant 7 (every axis
    # positive: the left child first; compute_links' right child is left + 1)
    left = torch.where(leaf, left, near[7])
    count = torch.where(leaf, count, 0)
    kind = torch.where(tlas, traversal.TLAS_LEAF, torch.where(blas, traversal.BLAS_LEAF,
                                                               traversal.INTERNAL))
    links = torch.stack([torch.where(leaf[None], -1, near), skip], dim=2)
    return box, torch.stack([left, kind, count], dim=1).to(torch.int32), links, tri


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_records_decode_to_the_split_tables(name):
    """Every node of the TLAS and BLAS blocks, in every octant: the box bit for
    bit, left, kind and count, and both links but a leaf's near, which holds
    the payload.  The pair rows hold the triangle rows, then two zeros."""
    bvh = _bvh(name)
    box, node, links, tri = _decode(bvh)
    assert torch.equal(box.view(torch.int32), bvh.box.view(torch.int32))
    assert torch.equal(node, bvh.node)
    leaf = (bvh.node[:, 1] != traversal.INTERNAL)[None].expand(8, -1)
    assert torch.equal(links[..., 1], bvh.links[..., 1])
    assert torch.equal(links[..., 0][~leaf], bvh.links[..., 0][~leaf])
    assert bool((links[..., 0][leaf] == -1).all()) and bool(leaf.any())
    assert torch.equal(tri.view(torch.int32), bvh.tri.view(torch.int32))
    assert not bvh.pairs[:, 18:].any()
    kinds = set(bvh.node[:, 1].tolist())
    assert kinds == {traversal.INTERNAL, traversal.TLAS_LEAF, traversal.BLAS_LEAF}


def test_scene_bvh_packs_the_records():
    bvh = _bvh("config4")
    assert torch.equal(bvh.rec, traversal.octant_records(bvh.box, bvh.node, bvh.links))
    assert torch.equal(bvh.pairs, traversal.pair_rows(bvh.tri))


def _rays(name, bvh, cfg):
    """The primaries, and the shadow rays of every light from their plain
    closest hits (origins on the surfaces; config4's directional light points
    along an axis, so its rays have 0 direction components), as (o, d, t_max,
    active)."""
    scene = _scene(name)[0]
    rays = renderer.generate_primary_rays(scene, cfg)
    n = rays.count
    prim = (rays.origin, rays.direction, torch.full((n,), float("inf")),
            torch.ones((n,), dtype=torch.bool))
    w = traversal.trace_plain(bvh, *prim, True, False)
    hit = w.best >= 0
    point = prim[0] + torch.where(hit, w.t, 0.0)[:, None] * prim[1]
    lights = torch.cat([scene.pl_pos, scene.sl_pos])
    to_l = lights[:, None, :] - point[None]
    dist = torch.linalg.norm(to_l, dim=2)
    k = lights.shape[0] + scene.dl_neg_dir.shape[0]
    dirs = torch.cat([(to_l / dist[..., None]).reshape(-1, 3),
                      scene.dl_neg_dir.repeat_interleave(n, dim=0)])
    dist = torch.cat([dist.reshape(-1), torch.full((scene.dl_neg_dir.shape[0] * n,),
                                                   float("inf"))])
    shadow = (point.repeat(k, 1), dirs, dist, hit.repeat(k))
    return prim, tuple(x.contiguous() for x in shadow)


@pytest.mark.parametrize("strategy", ["ORDERED", "NAIVE"])
@pytest.mark.parametrize("name", ["config3", "config4"])
def test_walk_over_decoded_records_matches_plain(name, strategy):
    """trace_plain over the tables decoded from the records and pair rows alone
    gives best, t, steps, pairs, entries and found equal to trace_plain over the
    split tables, on the primaries and their shadow rays."""
    bvh = _bvh(name)
    cfg = _scene(name)[1]
    box, node, links, tri = _decode(bvh)
    decoded = bvh._replace(box=box, node=node, links=links, tri=tri)
    ordered = strategy == "ORDERED"
    prim, shadow = _rays(name, bvh, cfg.replace(
        traversal_strategy=TraversalStrategy[strategy]))
    for rays, any_hit in ((prim, False), (shadow, True)):
        want = traversal.trace_plain(bvh, *rays, ordered, any_hit)
        got = traversal.trace_plain(decoded, *rays, ordered, any_hit)
        for field in ("best", "steps", "pairs", "entries", "found"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
        assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
        assert int(want.steps.sum()) > 0 and int(want.entries.sum()) > 0
    assert bool(shadow[3].any()) and bool((~shadow[3]).any())


def test_packers_refuse_values_beyond_their_bits():
    """A BLAS leaf's left / 2 past 21 bits or count / 2 past 9, a TLAS leaf's
    instance past 8 bits or count past 21, an internal node whose near is not a
    node, a node count of 2^22 and an odd number of triangle rows are
    refused."""
    bvh = _bvh("config4")
    box, node, links = bvh.box, bvh.node, bvh.links
    blas = int(torch.nonzero(node[:, 1] == traversal.BLAS_LEAF)[0])
    tlas = int(torch.nonzero(node[:, 1] == traversal.TLAS_LEAF)[0])
    inner = int(torch.nonzero(node[:, 1] == traversal.INTERNAL)[0])

    def with_node(row, col, value):
        n = node.clone()
        n[row, col] = value
        return n

    traversal.octant_records(box, with_node(blas, 0, (1 << 22) - 2), links)  # the largest
    traversal.octant_records(box, with_node(blas, 2, (1 << 10) - 2), links)
    traversal.octant_records(box, with_node(tlas, 0, 255), links)
    for bad, what in ((with_node(blas, 0, 1 << 22), "left / 2"),
                      (with_node(blas, 2, 1 << 10), "count / 2"),
                      (with_node(tlas, 0, 256), "instance"),
                      (with_node(tlas, 2, 1 << 21), "instance"),
                      (with_node(blas, 2, -2), "count / 2"),
                      (with_node(inner, 1, 3), "kinds")):
        with pytest.raises(ValueError, match=what):
            traversal.octant_records(box, bad, links)
    bad_links = links.clone()
    bad_links[3, inner, 0] = traversal.BLAS_EXIT
    with pytest.raises(ValueError, match="near link"):
        traversal.octant_records(box, node, bad_links)
    big = 1 << 22
    with pytest.raises(ValueError, match="2\\^22"):
        traversal.octant_records(box[:1].expand(big, 6), node[:1].expand(big, 3),
                                 links[:, :1].expand(8, big, 2))
    with pytest.raises(ValueError, match="even"):
        traversal.pair_rows(bvh.tri[:-1])
