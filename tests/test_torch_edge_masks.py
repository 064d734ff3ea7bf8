"""The masks at the edges of the tree kernels' design, and their checks.

The tree kernels (csrc/tree_attention_body.cuh) load a 32-key chunk only if
a row of the CTA's tile admits a key in it, and give a row that admits
nothing the mean of V.  ``edge_mask`` makes the masks at the edges of that
design; the card tests (tests/test_torch_cuda.py) hold the kernels on them
and tests/test_torch_attention_schedule.py holds its CPU model of the
algorithm on them.  The tests here check that each kind is the edge it is
named for.  numpy only: the card tests import this module without JAX.
"""
import numpy as np
import pytest

CHUNK = 32  # keys per chunk in the kernels

EDGE_KINDS = ["one live chunk", "wrapped ring", "runs straddling chunk edges", "fully masked row in a tile"]


def edge_mask(kind, Bm, T, S, seed=0, prefix=0):
    """(Bm, T, S) bool, numpy.  Rows differ, as tree rows do.  ``prefix``
    slots [0, prefix) are admitted by every row first (a long committed
    cache), so only the last kinds' slots sit past it."""
    rng = np.random.default_rng(seed)
    m = np.zeros((Bm, T, S), bool)
    m[:, :, :prefix] = True
    tail = S - prefix
    for b in range(Bm):
        for t in range(T):
            row = m[b, t, prefix:]
            if kind == "one live chunk":  # every admitted slot in one 32-slot chunk
                c0 = CHUNK * ((tail // CHUNK) // 2)
                row[c0 + rng.choice(min(CHUNK, tail - c0), size=1 + (t + b) % 8, replace=False)] = True
            elif kind == "wrapped ring":  # a ring that wrapped: the newest slots at both ends
                row[tail - 9 + (b + t) % 3:] = True
                row[: 5 + t % 7] = True
            elif kind == "runs straddling chunk edges":
                row[27 - t % 4: 37 + t % 3] = True
                e = CHUNK * (tail // 64) + CHUNK
                row[e - 5 - b % 2: min(tail, e + 4 + t % 2)] = True
            else:  # sparse random rows, one of them fully masked
                row[rng.random(tail) < 0.1] = True
        if kind == "fully masked row in a tile":
            m[b, T // 2] = False
    return m


# the (Bm, T, S) the card tests and the schedule tests draw these masks at
SHAPES = [(1, 7, 1024), (2, 17, 1024), (3, 33, 512), (1, 1, 1000), (2, 17, 256), (1, 32, 256)]


def _chunks(row):
    return sorted({int(s) // CHUNK for s in np.flatnonzero(row)})


@pytest.mark.parametrize("Bm,T,S", SHAPES)
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_edge_mask_is_its_edge(kind, Bm, T, S):
    m = edge_mask(kind, Bm, T, S, seed=T)
    assert m.shape == (Bm, T, S) and m.dtype == bool
    rows = m.reshape(-1, S)
    if kind == "one live chunk":
        assert all(len(_chunks(r)) == 1 for r in rows)
        assert len({tuple(_chunks(r)) for r in rows}) == 1  # one live chunk for the whole tile
    elif kind == "wrapped ring":
        assert rows[:, 0].all() and rows[:, -1].all()
        assert not rows[:, 16:S - 16].any()  # nothing between the two ends
    elif kind == "runs straddling chunk edges":
        for r in rows:
            edges = [c for c in range(CHUNK, S, CHUNK) if r[c - 1] and r[c]]
            assert len(edges) >= 2 or (S <= 64 and edges)
    else:
        for b in range(Bm):
            assert not m[b, T // 2].any()  # the fully masked row
            others = np.delete(m[b], T // 2, axis=0)
            assert others.any(axis=1).all()  # ... in a tile whose other rows admit keys
    if T > 1:  # rows differ, as tree rows do
        assert not (rows == rows[0]).all()


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_edge_mask_prefix_is_admitted_by_every_row(kind):
    m = edge_mask(kind, 2, 7, 4096, prefix=3000)
    keep = np.arange(7) != (7 // 2 if kind == "fully masked row in a tile" else -1)
    assert m[:, keep, :3000].all()
    tail = m[:, :, 3000:]
    np.testing.assert_array_equal(tail, edge_mask(kind, 2, 7, 1096))  # the kind sits past the prefix
