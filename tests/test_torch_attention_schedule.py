"""The tree kernels' algorithm, on the CPU, against the plain versions.

The CUDA tree kernels (csrc/tree_attention_body.cuh, shared by
``tree_attention``, ``paged_tree_attention`` and
``ragged_paged_tree_attention``) run only on the card.  Their algorithm is
modelled here in plain torch, step for step: the tiles of query rows (cut at
owner changes for the ragged pass), the heads a CTA serves, the key ranges
of the splits from ``launch_schedule``, the live-chunk bitmap from the
mask, the live chunks dealt to the CTA's warp teams (as the bf16 kernel
deals them), an online (m, l, acc) per team over its chunks only, the
teams' merge, the combine of the splits and the fully masked row rule (the
mean of V over all S slots).  Each case
holds the port's CPU entry points (``kernels.ops``, which run the plain
versions) against the JAX package's oracles, and the model against the
port, in float32 to 1e-5 on seeded numpy inputs, at the masks the card
tests use (tests/test_torch_edge_masks.py), and with small splits so that
the split path runs at small S.  The schedule rule itself is tested too.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro_torch.kernels.ops import gqa_paged_tree_attention, gqa_ragged_tree_attention, gqa_tree_attention
from repro_torch.kernels.ref import paged_gather_kv_ref
from repro_torch.kernels.tree_attention import (
    CHUNK,
    MAX_QUERY_ROWS,
    MAX_SCORE_ROWS,
    SPLIT_ABOVE,
    SPLIT_SLOTS,
    launch_schedule,
    max_score_rows,
)
from test_torch_edge_masks import EDGE_KINDS, edge_mask

ATOL = 1e-5
NEG_INF = -1e30
WARPS, WARP_ROWS = 8, 16  # the bf16 kernel's warps and rows per warp tile


def n_teams(score_rows, D):
    """Warp teams of a CTA in the bf16 kernel: each team holds every 16-row
    tile of the score rows, at most one team per chunk of a stage (4 chunks,
    2 at D 256)."""
    return min(4 if D <= 128 else 2, WARPS // -(-score_rows // WARP_ROWS))


def merge(m, l, acc, m2, l2, acc2):
    """Two online-softmax states of the same rows, merged."""
    M = torch.maximum(m, m2)
    a, b = torch.exp(m - M), torch.exp(m2 - M)
    return M, l * a + l2 * b, acc * a[..., None] + acc2 * b[..., None]


# ----------------------------------------------------------- the model ---


def dense_tiles(B, T, tq):
    """Query-row ranges [r0, r1) of the dense and padded launches: tiles of
    tq rows inside each batch row (row r = b * T + t)."""
    return [(b * T + t0, b * T + min(T, t0 + tq)) for b in range(B) for t0 in range(0, T, tq)]


def ragged_tiles(owner, tq):
    """The ragged launch's tiles as the card cuts them: a tile starts at
    every owner change and every tq nodes inside a run, and ends at the run's
    end or tq nodes later."""
    tiles, n = [], len(owner)
    for x in range(n):
        start = x
        while start > 0 and owner[start - 1] == owner[x]:
            start -= 1
        if (x - start) % tq:
            continue
        end = x + 1
        while end < min(n, x + tq) and owner[end] == owner[x]:
            end += 1
        tiles.append((x, end))
    return tiles


def model(q, kview, vview, mask, view, tiles, gh, split_slots, live_log=None):
    """The kernels' algorithm.  q (R, H, D); kview, vview (B, S, Hkv, D) the
    K/V views (a paged arena gathered through its table); mask (R, S) bool;
    view (R,) the view each query row reads, -1 for a padding lane;
    tiles the query-row ranges of the CTAs.  Returns (R, H, D) float32.
    ``live_log`` collects (tile, kvh, split, live chunks) when given."""
    R, H, D = q.shape
    S, Hkv = kview.shape[1], kview.shape[2]
    G = H // Hkv
    n_split = -(-S // split_slots)
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros(R, H, D)
    part_m = torch.full((n_split, R, H), NEG_INF)
    part_l = torch.zeros(n_split, R, H)
    part_acc = torch.zeros(n_split, R, H, D)
    for r0, r1 in tiles:
        b = int(view[r0])
        assert (view[r0:r1] == b).all(), "a tile reads one view"
        if b < 0:
            continue  # padding lanes: zeros
        for kvh in range(Hkv):
            for g0 in range(0, G, gh):
                heads = list(range(kvh * G + g0, kvh * G + min(G, g0 + gh)))
                assert (r1 - r0) * len(heads) <= max_score_rows(D)
                for split in range(n_split):
                    lo, hi = split * split_slots, min(S, (split + 1) * split_slots)
                    mk = mask[r0:r1, lo:hi]
                    live = [c for c in range(-(-(hi - lo) // CHUNK)) if mk[:, CHUNK * c:CHUNK * (c + 1)].any()]
                    if live_log is not None:
                        live_log.append(((r0, r1), kvh, split, live))
                    qh = q[r0:r1, heads].float()  # (nq, ng, D)
                    teams = n_teams((r1 - r0) * len(heads), D)
                    states = []
                    for team in range(teams):  # team t takes live chunks t, t + teams, ...
                        m = torch.full(qh.shape[:2], NEG_INF)
                        l = torch.zeros(qh.shape[:2])
                        acc = torch.zeros(qh.shape)
                        for c in live[team::teams]:
                            keys = slice(lo + CHUNK * c, min(hi, lo + CHUNK * (c + 1)))
                            kc, vc = kview[b, keys, kvh].float(), vview[b, keys, kvh].float()
                            s = torch.einsum("qgd,kd->qgk", qh, kc) * scale
                            adm = mask[r0:r1, keys][:, None, :].expand_as(s)
                            m_new = torch.maximum(m, torch.where(adm, s, NEG_INF).amax(dim=-1))
                            alpha = torch.exp(m - m_new)
                            p = torch.where(adm, torch.exp(s - m_new[..., None]), 0.0)  # masked: weight 0
                            l = l * alpha + p.sum(dim=-1)
                            acc = acc * alpha[..., None] + torch.einsum("qgk,kd->qgd", p, vc)
                            m = m_new
                        states.append((m, l, acc))
                    m, l, acc = states[0]
                    for other in states[1:]:
                        m, l, acc = merge(m, l, acc, *other)
                    if n_split == 1:
                        full = l == 0  # admits nothing: the mean of V over every slot
                        acc[full] = vview[b, lo:hi, kvh].float().sum(dim=0)
                        l = torch.where(full, float(hi - lo), l)
                        out[r0:r1, heads] = acc / l.clamp_min(1e-30)[..., None]
                    else:
                        part_m[split, r0:r1, heads], part_l[split, r0:r1, heads] = m, l
                        part_acc[split, r0:r1, heads] = acc
    if n_split > 1:  # the combine
        has = part_l > 0
        M = torch.where(has, part_m, NEG_INF).amax(dim=0)
        w = torch.where(has, torch.exp(part_m - M), 0.0)
        merged = (part_acc * w[..., None]).sum(dim=0) / (part_l * w).sum(dim=0).clamp_min(1e-30)[..., None]
        for r in range(R):
            b = int(view[r])
            if b < 0:
                continue
            for h in range(H):
                out[r, h] = merged[r, h] if has[:, r, h].any() else vview[b, :, h // G].float().mean(dim=0)
    return out


def schedule(H, Hkv, S, split, D):
    """launch_schedule, or the same with ``split`` slots per split (to run
    the split path at a small S)."""
    tq, gh, split_slots, n_split = launch_schedule(H, Hkv, S, D)
    return (tq, gh, split_slots) if split is None else (tq, gh, split)


def _jax_dense_ref(q, k, v, mask):
    """The JAX oracle in its (BH, T, D) layout, back to (B, T, H, D)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, T, D)
    kf = np.repeat(k.transpose(0, 2, 1, 3), H // Hkv, axis=1).reshape(B * H, S, D)
    vf = np.repeat(v.transpose(0, 2, 1, 3), H // Hkv, axis=1).reshape(B * H, S, D)
    mf = np.broadcast_to(np.broadcast_to(mask, (B, T, S))[:, None], (B, H, T, S)).reshape(B * H, T, S)
    out = np.asarray(jref.tree_attention_ref(*(jnp.asarray(a) for a in (qf, kf, vf, mf))))
    return out.reshape(B, H, T, D).transpose(0, 2, 1, 3)


# ------------------------------------------------------------ the rule ---


@pytest.mark.parametrize("H,Hkv,S,n_split,D", [
    (32, 8, 1024, 1, 128), (16, 4, 1024, 1, 128), (64, 4, 1024, 1, 128), (32, 2, 1024, 1, 128),  # engines'
    (4, 4, 33, 1, 128), (8, 8, 4096, 1, 128), (256, 1, 100, 1, 128), (12, 2, 300, 1, 128),
    (32, 8, 32768, 16, 128),   # granite heads on a 32768-slot ring
    (64, 4, 32768, 16, 128),   # qwen3-moe heads: the split depends on S alone
    (32, 8, 4097, 3, 128),     # just past the threshold
    (16, 4, 6000, 3, 128),
    (32, 8, 1 << 20, 512, 128),
    (10, 1, 1024, 1, 256),     # recurrentgemma-2b's local attention: G 10, head_dim 256
    (10, 1, 4608, 3, 256),     # a ring past the 4096-slot threshold
    (256, 1, 100, 1, 256),     # G past the 64 rows of a D 256 CTA
    (6, 2, 512, 1, 32),        # examples/serve_speculative.py's target: 6/2 heads of 32, max_cache 512
    (2, 1, 512, 1, 48),        # its draft: 2/1 heads of 48
    (6, 2, 8192, 4, 32),       # both past the threshold: the split depends on S alone
    (2, 1, 8192, 4, 48),
])
def test_launch_schedule_rule(H, Hkv, S, n_split, D):
    tq, gh, split_slots, got = launch_schedule(H, Hkv, S, D)
    G = H // Hkv
    rows = max_score_rows(D)
    assert rows == (MAX_SCORE_ROWS if D <= 128 else MAX_SCORE_ROWS // 2)
    assert 1 <= tq <= MAX_QUERY_ROWS and 1 <= gh <= G and tq * gh <= rows
    assert gh == min(G, rows)  # a KV head's whole group per CTA when it fits
    assert got == n_split and split_slots % CHUNK == 0 and n_split * split_slots >= S > (n_split - 1) * split_slots
    if S <= SPLIT_ABOVE:  # one key range: one launch per call
        assert split_slots < S + CHUNK
    else:
        assert split_slots == SPLIT_SLOTS


@pytest.mark.parametrize("owner,tq", [
    ([0, 0, 0, 2, 2, 1, 1, 1, 1, 0], 32),
    ([0] * 20 + [1] * 3 + [0] * 5 + [-1] * 4, 8),
    ([2] * 40 + [1] * 7 + [2] * 2 + [-1] * 15, 32),
    ([0, 1] * 9 + [-1, 1, -1], 32),
    ([5] * 70, 32),
])
def test_ragged_tiles_cut_at_owner_changes(owner, tq):
    tiles = ragged_tiles(owner, tq)
    covered = [r for r0, r1 in tiles for r in range(r0, r1)]
    assert covered == list(range(len(owner)))  # every node in exactly one tile, in order
    for r0, r1 in tiles:
        assert 1 <= r1 - r0 <= tq and len(set(owner[r0:r1])) == 1
        run_start = r0
        while run_start > 0 and owner[run_start - 1] == owner[r0]:
            run_start -= 1
        assert (r0 - run_start) % tq == 0


# ----------------------------------------------- the model vs the oracles ---


@pytest.mark.parametrize("split", [None, 64])
@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("B,T,H,Hkv,S,D,Bm", [
    (1, 7, 8, 2, 256, 32, 1),    # G 4, the tree pass's shape at small width
    (2, 17, 16, 1, 256, 32, 2),  # G 16: tiles of 8 query rows, a mask per row
    (2, 33, 2, 2, 192, 16, 1),   # G 1: tiles of 32 query rows, one mask for B 2
    (1, 14, 10, 1, 128, 256, 1),  # recurrentgemma-2b's heads, head_dim 256: tiles of 6 query rows
    (2, 7, 2, 1, 128, 48, 2),    # examples/serve_speculative.py's draft heads (2/1 of 48), a mask per row
])
def test_model_matches_tree_attention_oracles(split, kind, B, T, H, Hkv, S, D, Bm):
    rng = np.random.default_rng(T * 10 + H)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    mask = edge_mask(kind, Bm, T, S, seed=T)
    tq, gh, split_slots = schedule(H, Hkv, S, split, D)
    rows_mask = torch.from_numpy(np.broadcast_to(mask, (B, T, S)).reshape(B * T, S).copy())
    view = torch.arange(B).repeat_interleave(T)
    log = []
    got = model(torch.from_numpy(q).reshape(B * T, H, D), torch.from_numpy(k), torch.from_numpy(v), rows_mask,
                view, dense_tiles(B, T, tq), gh, split_slots, log).reshape(B, T, H, D).numpy()
    want = gqa_tree_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(want, _jax_dense_ref(q, k, v, mask), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if kind == "one live chunk" and split is None:  # one chunk loaded per CTA, every other skipped
        assert all(len(live) == 1 for *_, live in log)


@pytest.mark.parametrize("split", [None, 128])
@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("B,T,H,Hkv,D,block,nb,unmapped,Bm", [
    (3, 7, 8, 2, 32, 16, 16, 3, 3),   # unmapped tail blocks read the trash block
    (2, 17, 16, 1, 16, 32, 8, 1, 1),  # G 16, one mask for both rows
    (2, 5, 10, 1, 256, 16, 8, 2, 2),  # recurrentgemma-2b's heads, head_dim 256
])
def test_model_matches_paged_oracles(split, kind, B, T, H, Hkv, D, block, nb, unmapped, Bm):
    rng = np.random.default_rng(nb * 10 + T)
    S = nb * block
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B * nb + 2, block, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B * nb + 2, block, Hkv, D)).astype(np.float32)
    tbl = (rng.permutation(B * nb + 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    tbl[:, nb - unmapped:] = -1
    mask = edge_mask(kind, Bm, T, S, seed=B)
    tq, gh, split_slots = schedule(H, Hkv, S, split, D)
    kd, vd = paged_gather_kv_ref(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(tbl))
    rows_mask = torch.from_numpy(np.broadcast_to(mask, (B, T, S)).reshape(B * T, S).copy())
    got = model(torch.from_numpy(q).reshape(B * T, H, D), kd, vd, rows_mask, torch.arange(B).repeat_interleave(T),
                dense_tiles(B, T, tq), gh, split_slots).reshape(B, T, H, D).numpy()
    want = gqa_paged_tree_attention(*(torch.from_numpy(a) for a in (q, k, v, tbl, mask))).numpy()
    jk, jv = jref.paged_gather_kv_ref(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl))
    np.testing.assert_allclose(want, _jax_dense_ref(q, np.asarray(jk), np.asarray(jv), mask), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("split", [None, 96])
@pytest.mark.parametrize("owners,H,Hkv", [
    ([0] * 20 + [1] * 3 + [0] * 5 + [-1] * 4, 16, 1),  # G 16 (tiles of 8): a run over 3 tiles, 0 recurs
    ([2] * 40 + [1] * 7 + [2] * 2 + [-1] * 15, 8, 2),  # G 4 (tiles of 32): a run of 40
    ([0, 1] * 9 + [-1, 1, -1], 2, 2),                   # G 1: runs of one node, padding between
])
def test_model_matches_ragged_oracles(split, owners, H, Hkv):
    B, N, nb, block, D = max(owners) + 1, len(owners), 8, 32, 16
    rng = np.random.default_rng(N + H)
    S = nb * block
    q = rng.standard_normal((N, H, D)).astype(np.float32)
    k = rng.standard_normal((B * nb + 1, block, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B * nb + 1, block, Hkv, D)).astype(np.float32)
    tbl = (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    tbl[:, nb - 2:] = -1
    owner = np.asarray(owners, np.int32)
    mask = edge_mask("fully masked row in a tile", 1, N, S, seed=N)[0]
    mask[3] |= edge_mask("runs straddling chunk edges", 1, 1, S)[0, 0]
    tq, gh, split_slots = schedule(H, Hkv, S, split, D)
    kd, vd = paged_gather_kv_ref(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(tbl))
    got = model(torch.from_numpy(q), kd, vd, torch.from_numpy(mask), torch.from_numpy(owner),
                ragged_tiles(owners, tq), gh, split_slots).numpy()
    want = gqa_ragged_tree_attention(*(torch.from_numpy(a) for a in (q, k, v, tbl, owner, mask))).numpy()
    real = owner >= 0  # the JAX oracle gives padding lanes no meaning; the port writes zeros
    jout = np.asarray(jref.ragged_tree_attention_ref(*(jnp.asarray(a) for a in (q, k, v, tbl, owner, mask))))
    np.testing.assert_allclose(want[real], jout[real], atol=ATOL, rtol=0)
    assert not want[~real].any()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
