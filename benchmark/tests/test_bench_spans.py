"""The readers of the program's own spans (``rt.*``): on a made-up profile of two
frames, each reader's count or self time (a range's duration less the ``rt.*``
ranges inside it) over the frames; nothing read without a profile or from a
program that has no spans."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness

# (name, start, end) in us; two frames; a generic host event ("aten::add") inside
# a stage is part of the stage's self time
RANGES = [
    ("frame", 0, 100), ("render", 1, 99),
    ("rt.render", 2, 98),
    ("rt.tables", 2, 12), ("rt.host_read", 5, 8), ("aten::cat", 3, 4),
    ("rt.primary", 12, 20),
    ("rt.gen", 20, 98),
    ("rt.trace", 20, 40), ("rt.shade", 40, 50), ("aten::add", 41, 49),
    ("rt.shadow", 50, 60), ("rt.shade", 60, 65),
    ("rt.spawn", 65, 80),
    ("rt.compact", 80, 98), ("rt.host_read", 85, 95),
    ("frame", 100, 200), ("render", 101, 199),
    ("rt.render", 102, 198),
    ("rt.tables", 102, 104),
    ("rt.primary", 104, 110),
    ("rt.gen", 110, 198),
    ("rt.trace", 110, 150), ("rt.shade", 150, 170), ("rt.shadow", 170, 180),
    ("rt.shade", 180, 198),
]


def _ctx(ranges, frames=2):
    p = SimpleNamespace(frames=frames, host=(
        np.array([r[1] for r in ranges], np.float64),
        np.array([r[2] for r in ranges], np.float64),
        np.array([r[0] for r in ranges], dtype=object)))
    return SimpleNamespace(profile=p)


# per frame: host_read 2 reads, 3 + 10 us; tables (10 - 3) + (2) us; shade
# (10 + 5) + (20 + 18) us; spawn and compact 15 + (18 - 10) us, in frame one
WANT = {"host_reads_per_frame.render": 1.0, "read_wait_ms.render": 13e-3 / 2,
        "tables_ms.render": 9e-3 / 2, "shade_ms.render": 53e-3 / 2,
        "spawn_ms.render": 23e-3 / 2}


@pytest.mark.parametrize("name", list(WANT))
def test_reader_counts_and_self_time_a_frame(name):
    assert harness.reader(name).read(_ctx(RANGES)) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", list(WANT))
def test_reader_finds_nothing_without_the_programs_spans(name):
    r = harness.reader(name)
    assert r.read(SimpleNamespace(profile=None)) is None
    assert r.read(_ctx(RANGES, frames=0)) is None
    # the parent commit's program: the benchmark's own ranges, no rt.* span
    assert r.read(_ctx([x for x in RANGES if not x[0].startswith("rt.")])) is None


@pytest.mark.parametrize("name", list(WANT))
def test_a_stage_left_out_reads_zero(name):
    """A program with its spans whose frame has none of a reader's ranges (a
    table cache, a count kept on the card) reads 0, not nothing."""
    ranges = [x for x in RANGES if x[0] in ("frame", "render", "rt.render")]
    assert harness.reader(name).read(_ctx(ranges)) == 0.0
