"""The port's paged pool, its kernels' plain versions and its batched
forward against the JAX package, on the CPU, in float32.

  * kernels: ``kernels.ops`` gqa_paged_tree_attention /
    gqa_ragged_tree_attention / pool_commit_kv (plain versions on the CPU)
    against the JAX wrappers running the Pallas kernels in interpret mode
    and against the JAX oracles: attention to atol 1e-5, the commit exact;
  * the cache module: masks, the stream algebra, the commit step and the
    pools' host tables and free lists bit for bit, KV on admitted lanes;
  * ``forward`` over a per-stream ring (``lens``), a paged pool and the
    ragged node-major layout: logits to 1e-4, pos/len/tbl exact.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import cache as jc
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JConfig
from repro.serving import serve_step as jss
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.models import cache as tc
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import serve_step as tss

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _arena_inputs(rng, B, nb, block, Hkv, D, unmapped):
    """A random arena of B*nb + 2 blocks and a table of distinct blocks
    (block 0 is trash), with ``unmapped`` trailing entries per row at -1."""
    nblk = B * nb + 2
    k = rng.standard_normal((nblk, block, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((nblk, block, Hkv, D)).astype(np.float32)
    tbl = (rng.permutation(nblk - 1)[: B * nb] + 1).reshape(B, nb).astype(np.int32)
    if unmapped:
        tbl[:, nb - unmapped:] = -1
    return k, v, tbl


@pytest.mark.parametrize("B,T,H,Hkv,D,block,nb,unmapped,Bm", [
    (3, 7, 8, 2, 32, 8, 4, 1, 3),    # padded tree pass, unmapped tail
    (2, 1, 4, 4, 64, 16, 2, 0, 1),   # decode-shaped, shared mask
    (2, 4, 8, 1, 16, 4, 5, 2, 2),    # G = 8, small blocks
])
def test_paged_tree_attention_matches_jax(B, T, H, Hkv, D, block, nb, unmapped, Bm):
    rng = np.random.default_rng(B * 10 + T)
    k, v, tbl = _arena_inputs(rng, B, nb, block, Hkv, D, unmapped)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    mask = rng.random((Bm, T, nb * block)) < 0.3
    mask[0, T - 1] = False  # fully masked: the mean of V over the logical view
    got = tops.gqa_paged_tree_attention(_t(q), _t(k), _t(v), _t(tbl), _t(mask)).numpy()
    assert np.isfinite(got).all()
    pallas = jops.gqa_paged_tree_attention(*(jnp.asarray(a) for a in (q, k, v, tbl, mask)), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    kd, vd = jref.paged_gather_kv_ref(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl))
    G = H // Hkv
    S = nb * block
    want = jref.tree_attention_ref(
        jnp.asarray(q.transpose(0, 2, 1, 3).reshape(B * H, T, D)),
        jnp.repeat(kd.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, S, D),
        jnp.repeat(vd.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, S, D),
        jnp.asarray(np.repeat(np.broadcast_to(mask, (B, T, S))[:, None], H, axis=1).reshape(B * H, T, S)))
    np.testing.assert_allclose(got, np.asarray(want).reshape(B, H, T, D).transpose(0, 2, 1, 3),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("owners", [
    [1] * 8 + [0] * 8 + [2] * 8,        # owner-uniform 8-row tiles: the Pallas kernel's contract
    [0, 0, 0, 2, 2, 1, 1, 1, 1, 0, 2],  # per-node owners, no alignment (the port's layout)
    [2, 2, 2, 0, 0, 0, 0, -1, -1],      # padding lanes (owner -1): zeros, nothing read
])
def test_ragged_tree_attention_matches_jax(owners):
    rng = np.random.default_rng(len(owners))
    B, nb, block, H, Hkv, D = 3, 4, 8, 8, 2, 32
    k, v, tbl = _arena_inputs(rng, B, nb, block, Hkv, D, unmapped=1)
    N = len(owners)
    q = rng.standard_normal((N, H, D)).astype(np.float32)
    owner = np.asarray(owners, np.int32)
    real = owner >= 0
    mask = rng.random((N, nb * block)) < 0.3
    mask[np.flatnonzero(real)[-1]] = False  # a fully masked node: the mean of V
    got = tops.gqa_ragged_tree_attention(*(_t(a) for a in (q, k, v, tbl, owner, mask))).numpy()
    assert np.isfinite(got).all()
    assert not got[~real].any()
    args = (q, k, v, tbl, np.maximum(owner, 0), mask)  # the JAX package attends padding over row 0
    want = jref.ragged_tree_attention_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got[real], np.asarray(want)[real], atol=ATOL, rtol=0)
    if N % 8 == 0:
        pallas = jops.gqa_ragged_tree_attention(*(jnp.asarray(a) for a in args), interpret=True)
        np.testing.assert_allclose(got[real], np.asarray(pallas)[real], atol=ATOL, rtol=0)


def test_commit_kv_matches_jax_exactly():
    """A chain (entry j's source is entry j+1's destination), duplicated
    identity padding on one lane, and a second row with its own path."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 2, 24, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 2, 24, 2, 8)).astype(np.float32)
    src = np.asarray([[12, 13, 14, 10, 10, 10], [5, 7, 9, 4, 4, 4]], np.int32)
    dst = np.asarray([[11, 12, 13, 10, 10, 10], [4 + 1, 4 + 2, 4 + 3, 4, 4, 4]], np.int32)
    tk, tv = tops.pool_commit_kv(_t(k), _t(v), _t(src), _t(dst))
    for jk, jv in (jops.pool_commit_kv(*(jnp.asarray(a) for a in (k, v, src, dst)), use_pallas=True),
                   jref.commit_kv_ref(*(jnp.asarray(a) for a in (k, v, src, dst)))):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_commit_kv_moves_nothing_for_identity_or_out_of_range_entries():
    """The plain version's contract, which the kernel shares: an entry with
    src == dst or an index outside [0, Smax) moves nothing; the others move
    with gather-then-scatter semantics."""
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 2, 12, 1, 4)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 1, 4)).astype(np.float32)
    src = np.asarray([[3, 4, 12, -1, 6], [2, 2, 5, 9, 1]], np.int32)
    dst = np.asarray([[2, 3, 7, 8, 6], [1, -1, 40, 9, 0]], np.int32)
    tk, tv = tops.pool_commit_kv(_t(k), _t(v), _t(src), _t(dst))
    want_k, want_v = k.copy(), v.copy()
    for b, s_, d_ in ((0, 3, 2), (0, 4, 3), (1, 2, 1), (1, 1, 0)):  # the entries that move (chains)
        want_k[:, b, d_], want_v[:, b, d_] = k[:, b, s_], v[:, b, s_]
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tv.numpy(), want_v)


# ------------------------------------------------------------ cache module ---

L, B, S, H, HD, BLK = 2, 3, 16, 2, 4, 4
NB_PER = S // BLK


def _pools(rng):
    """The same paged pool on both sides (rows map different block counts;
    unmapped slots carry pos = -1) and its dense mirror."""
    nblk = B * NB_PER + 1
    k = rng.normal(size=(L, nblk, BLK, H, HD)).astype(np.float32)
    v = rng.normal(size=(L, nblk, BLK, H, HD)).astype(np.float32)
    tbl = (rng.permutation(nblk - 1) + 1).reshape(B, NB_PER).astype(np.int32)
    pos = rng.integers(-1, 4 * S, size=(B, S)).astype(np.int32)
    for b in range(B):
        keep = int(rng.integers(1, NB_PER + 1))
        tbl[b, keep:] = -1
        pos[b, keep * BLK:] = -1
    ln = rng.integers(0, 4 * S, size=(B,)).astype(np.int32)
    arrays = {"k": k, "v": v, "block_tbl": tbl, "pos": pos, "len": ln}
    return ({"attn": {n: jnp.asarray(a) for n, a in arrays.items()}},
            {"attn": {n: _t(a) for n, a in arrays.items()}})


def _same(tcache, jcache, exact=True, lanes=None):
    tn = bridge.cache_to_numpy(tcache)["attn"]
    jn = jax.tree.map(np.asarray, jcache)["attn"]
    assert sorted(tn) == sorted(jn)
    for name in tn:
        t, j = tn[name], jn[name]
        assert t.shape == j.shape, name
        if name in ("k", "v") and lanes is not None:
            t, j = t[:, lanes], j[:, lanes]
        if exact or name not in ("k", "v"):
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_algebra_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jp, tp = _pools(rng)
    rows = [2, 0]
    _same(tc.gather_streams(tp, rows), jc.gather_streams(jp, rows))
    _same(tc.fork_streams(tp, 2), jc.fork_streams(jp, 2))
    ja, jb = jc.gather_streams(jp, [1]), jc.gather_streams(jp, rows)
    ta, tb = tc.gather_streams(tp, [1]), tc.gather_streams(tp, rows)
    _same(tc.concat_streams([ta, tb]), jc.concat_streams([ja, jb]))
    # scatter a shifted copy of rows back (k/v in place on the port's side)
    jrows = jax.tree.map(lambda a: a + 1, jb)
    trows = {"attn": {n: t + 1 for n, t in tb["attn"].items()}}
    _same(tc.scatter_streams(tc.clone_cache(tp), trows, rows), jc.scatter_streams(jp, jrows, rows))
    # merge: distinct k/v select by owned block; shared k/v stay as they are
    keep = np.asarray([True, False, True])
    jnew = {"attn": {**jp["attn"], "k": jp["attn"]["k"] * 2, "pos": jp["attn"]["pos"] + 1}}
    tnew = {"attn": {**tp["attn"], "k": tp["attn"]["k"] * 2, "pos": tp["attn"]["pos"] + 1}}
    _same(tc.merge_streams(tnew, tp, keep), jc.merge_streams(jnew, jp, keep))
    shared = tc.merge_streams({"attn": {**tp["attn"], "pos": tnew["attn"]["pos"]}}, tp, keep)
    assert shared["attn"]["k"] is tp["attn"]["k"]
    np.testing.assert_array_equal(shared["attn"]["pos"].numpy(),
                                  np.asarray(jc.merge_streams(jnew, jp, keep)["attn"]["pos"]))
    # the dense per-stream ring layout
    jd, td = jc.gather_streams(jp, [0, 1, 2]), tc.gather_streams(tp, [0, 1, 2])
    _same(tc.merge_streams({"attn": {**td["attn"], "k": td["attn"]["k"] + 3}}, td, keep),
          jc.merge_streams({"attn": {**jd["attn"], "k": jd["attn"]["k"] + 3}}, jd, keep))
    _same(tc.scatter_streams(td, tc.gather_streams(td, [1]), [2]),
          jc.scatter_streams(jd, jc.gather_streams(jd, [1]), [2]))


def _commit_args(rng, Tpad):
    P = 4
    npath = np.zeros((B, P), np.int32)
    plen = np.zeros((B,), np.int32)
    C = np.zeros((B,), np.int32)
    active = np.asarray([True, False, True])
    for b in (0, 2):
        tau = int(rng.integers(0, min(P, Tpad - 1) + 1))
        path = sorted(rng.choice(np.arange(1, Tpad), size=tau, replace=False).tolist())
        npath[b, :tau] = path
        plen[b] = tau
        C[b] = int(rng.integers(1, S - Tpad))
    return npath, plen, C, active


@pytest.mark.parametrize("seed,Tpad", [(0, 4), (1, 7), (2, 5)])
def test_commit_step_matches_jax(seed, Tpad):
    """The fused commit on a paged pool (fully mapped rows, so every touched
    lane is admitted) and on the dense ring: tables exact, KV exact."""
    rng = np.random.default_rng(seed)
    jp, tp = _pools(rng)
    tbl = (np.arange(B * NB_PER) + 1).reshape(B, NB_PER).astype(np.int32)
    jp["attn"]["block_tbl"], tp["attn"]["block_tbl"] = jnp.asarray(tbl), _t(tbl)
    args = _commit_args(rng, Tpad)
    jcfg = JConfig(attention_impl="pallas")
    for jcache, tcache in ((jp, tp), (jc.gather_streams(jp, range(B)), tc.gather_streams(tp, range(B)))):
        want = jss.make_pool_commit_step(jcfg, Tpad)(jcache, *(jnp.asarray(a) for a in args))
        got = tss.make_pool_commit_step(Tpad)(tcache, *(_t(a) for a in args))
        _same(got, want)


def test_masks_and_ancestors_match_jax():
    rng = np.random.default_rng(7)
    # per-stream masks
    pos = rng.integers(-1, 12, size=(B, S)).astype(np.int32)
    qpos = rng.integers(0, 12, size=(B, 5)).astype(np.int32)
    np.testing.assert_array_equal(tc.attn_mask_from_pos(_t(pos), _t(qpos), 4).numpy(),
                                  np.asarray(jc.attn_mask_from_pos(jnp.asarray(pos), jnp.asarray(qpos), 4)))
    parents = np.asarray([[-1, 0, 1, 1, 2], [-1, 0, 0, 1, -1], [-1, -1, -1, -1, -1]], np.int32)
    anc = tss.device_ancestor_mask(_t(parents))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(jss.device_ancestor_mask(jnp.asarray(parents))))
    slots = (np.arange(5)[None, :] + np.asarray([[3], [9], [14]])) % S
    np.testing.assert_array_equal(
        tc.tree_mask_from_pos(_t(pos), _t(qpos), anc, _t(slots.astype(np.int32))).numpy(),
        np.asarray(jc.tree_mask_from_pos(jnp.asarray(pos), jnp.asarray(qpos), jnp.asarray(anc.numpy()),
                                         jnp.asarray(slots))))
    # ragged: two trees back to back, padding lanes with the slot sentinel S
    owner = np.asarray([2, 2, 2, 0, 0, 0, 0, 0, 0], np.int32)
    parent = np.asarray([-1, 0, 1, -1, 3, 3, 4, -1, -1], np.int32)
    local = np.asarray([0, 1, 2, 0, 1, 2, 3, -1, -1], np.int32)
    rslots = np.where(local >= 0, (np.asarray([14] * 3 + [5] * 6) + np.maximum(local, 0)) % S, S)
    q_pos = rng.integers(0, 12, size=9).astype(np.int32)
    np.testing.assert_array_equal(
        tc.ragged_tree_mask(_t(pos), _t(q_pos), _t(owner), _t(rslots.astype(np.int32)), _t(parent)).numpy(),
        np.asarray(jc.ragged_tree_mask(*(jnp.asarray(a) for a in (pos, q_pos, owner, rslots, parent)))))


def _pool_state(tpool, jpool, smax):
    """Host tables and free lists bit for bit; pos/len/tbl exact; KV equal on
    every admitted lane of the logical views."""
    np.testing.assert_array_equal(tpool._tbl, jpool._tbl)
    assert tpool._free_blocks == jpool._free_blocks and tpool._free == jpool._free
    tv = tc.gather_streams(tpool.cache, range(tpool.n_slots))
    jv = jc.gather_streams(jpool.cache, range(jpool.n_slots))
    for name in ("pos", "len"):
        np.testing.assert_array_equal(tv["attn"][name].numpy(), np.asarray(jv["attn"][name]))
    np.testing.assert_array_equal(tpool.cache["attn"]["block_tbl"].numpy(),
                                  np.asarray(jpool.cache["attn"]["block_tbl"]))
    live = np.asarray(jv["attn"]["pos"]) >= 0
    for name in ("k", "v"):
        np.testing.assert_array_equal(tv["attn"][name].numpy()[:, live], np.asarray(jv["attn"][name])[:, live])


def test_paged_pool_lifecycle_matches_jax():
    jcfg = JConfig(n_layers=2, d_model=16, n_heads=2, n_kv_heads=2, head_dim=4, dtype="float32")
    tcfg = TConfig(n_layers=2, d_model=16, n_heads=2, n_kv_heads=2, head_dim=4, dtype="float32")
    smax, blk = 16, 4
    jpool = jc.PagedCachePool({"attn": jc.init_paged_attn_cache(jcfg, 2, 3, 7, blk, smax, jnp.float32)}, 3)
    tpool = tc.make_cache_pool({"attn": tc.init_paged_attn_cache(tcfg, 2, 3, 7, blk, smax, torch.float32,
                                                                 "cpu")}, 3)
    assert isinstance(tpool, tc.PagedCachePool) and tpool.total_blocks == 7
    rng = np.random.default_rng(0)

    def row(n):
        r = jc.init_attn_cache(jcfg, 2, 1, smax, jnp.float32, per_stream=True)
        r["k"] = jnp.asarray(rng.normal(size=r["k"].shape).astype(np.float32))
        r["v"] = jnp.asarray(rng.normal(size=r["v"].shape).astype(np.float32))
        r["pos"] = r["pos"].at[0, :n].set(jnp.arange(n, dtype=jnp.int32))
        r["len"] = r["len"].at[0].set(n)
        return {"attn": r}, {"attn": {k: _t(a) for k, a in r.items()}}

    for n in (5, 1, 9):
        jr, tr = row(n)
        assert tpool.admit(tr, ctx_len=n) == jpool.admit(jr, ctx_len=n)
        _pool_state(tpool, jpool, smax)
    for pool in (tpool, jpool):
        assert pool.free_blocks == 1
        assert not pool.ensure(1, 16)  # refused whole: needs 3 more blocks
        assert pool.ensure_rows({0: 7, 1: 5})
        assert pool.reclaim_tails({2: 4, 0: 2}) == 3
        pool.invalidate_from({2: 2, 1: 0})
        pool.release(0)
        assert pool.ensure(1, 12)
    _pool_state(tpool, jpool, smax)
    assert 0 not in tpool._free_blocks


# ----------------------------------------------------------------- forward ---

V = 32
JT = JConfig(name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
             vocab=V, dtype="float32")


def _tcfg(jcfg):
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})


@pytest.fixture(scope="module")
def weights():
    jp = jt.init_params(JT, jax.random.PRNGKey(0))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)


def _run_both(jcfg, jp, tp, jcache, tcache, toks, **kw):
    jl, jcache, jex = jt.forward(jp, jcfg, jnp.asarray(toks), cache=jcache,
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else
                                    ({n: jnp.asarray(a) for n, a in v.items()} if isinstance(v, dict) else v)
                                    for k, v in kw.items()})
    tl, tcache, tex = tt.forward(tp, _tcfg(jcfg), _t(toks), cache=tcache,
                                 **{k: _t(v) if isinstance(v, np.ndarray) else
                                    ({n: _t(a) for n, a in v.items()} if isinstance(v, dict) else v)
                                    for k, v in kw.items()})
    return (np.asarray(jl), jcache), (tl.numpy(), tcache)


def _check_pass(j, t, rows_or_nodes):
    (jl, jcache), (tl, tcache) = j, t
    np.testing.assert_allclose(tl[rows_or_nodes], jl[rows_or_nodes], atol=1e-4, rtol=0)
    jv = jc.gather_streams(jcache, range(3)) if "block_tbl" in jcache["attn"] else jcache
    tv = tc.gather_streams(tcache, range(3)) if "block_tbl" in tcache["attn"] else tcache
    live = np.asarray(jv["attn"]["pos"]) >= 0
    for name in ("pos", "len"):
        np.testing.assert_array_equal(tv["attn"][name].numpy(), np.asarray(jv["attn"][name]))
    if "block_tbl" in jcache["attn"]:
        np.testing.assert_array_equal(tcache["attn"]["block_tbl"].numpy(), np.asarray(jcache["attn"]["block_tbl"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tv["attn"][name].numpy()[:, live], np.asarray(jv["attn"][name])[:, live],
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("paged,impl", [(False, "xla"), (True, "xla"), (True, "pallas")])
def test_forward_per_stream_paged_and_ragged_match_jax(weights, paged, impl):
    """Prefill-like padded decode (lens), a padded tree pass with per-row
    trees and an idle row, the fused commit, then (paged) a ragged pass,
    from one start on both sides: logits on real rows/nodes to 1e-4, pos,
    len and tables exact, KV on admitted lanes."""
    jp, tp = weights
    jcfg = JT.replace(attention_impl=impl)
    smax, blk = 32, 8
    page = (10, blk) if paged else None
    jcache = jt.init_cache(jcfg, 3, smax, per_stream=True, page=page)
    tcache = tt.init_cache(_tcfg(jcfg), 3, smax, "cpu", per_stream=True, page=page)
    if paged:  # rows 0 and 1 map blocks, row 2 stays idle (unmapped: trash)
        tbl = np.full((3, smax // blk), -1, np.int32)
        tbl[0, :2], tbl[1, :2] = [3, 1], [2, 5]
        jcache["attn"]["block_tbl"] = jnp.asarray(tbl)
        tcache["attn"]["block_tbl"] = _t(tbl)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, V, size=(3, 4)).astype(np.int32)
    j, t = _run_both(jcfg, jp, tp, jcache, tcache, toks, mode="decode", lens=np.asarray([4, 2, 0], np.int32))
    _check_pass(j, t, np.s_[[0], :4])
    _check_pass(j, t, np.s_[[1], :2])
    jcache, tcache = j[1], t[1]

    parents = np.asarray([[-1, 0, 1, 1, 2, -1, -1], [-1, 0, 0, 1, 2, 3, 4], [-1] * 7], np.int32)
    anc = np.asarray(jss.device_ancestor_mask(jnp.asarray(parents)))
    toks = rng.integers(0, V, size=(3, 7)).astype(np.int32)
    j, t = _run_both(jcfg, jp, tp, jcache, tcache, toks, mode="tree", anc=anc)
    _check_pass(j, t, np.s_[:2])
    jcache = jc.merge_streams(j[1], jcache, jnp.asarray([True, True, False]))
    tcache = tc.merge_streams(t[1], tcache, _t(np.asarray([True, True, False])))

    npath = np.asarray([[1, 2, 0, 0], [1, 3, 5, 0], [0, 0, 0, 0]], np.int32)
    args = (npath, np.asarray([2, 3, 0], np.int32), np.asarray([3, 1, 0], np.int32), np.asarray([True, True, False]))
    jcache = jss.make_pool_commit_step(jcfg, 7)(jcache, *(jnp.asarray(a) for a in args))
    tcache = tss.make_pool_commit_step(7)(tcache, *(_t(a) for a in args))
    _check_pass((j[0], jcache), (t[0], tcache), np.s_[:2])
    if not paged or impl != "xla":
        return
    # ragged: row 1's 3-node tree, then row 0's 4-node tree, then padding lanes
    ragged = {"owner": np.asarray([1, 1, 1, 0, 0, 0, 0, 0], np.int32),
              "parent": np.asarray([-1, 0, 0, -1, 3, 4, 4, -1], np.int32),
              "depth": np.asarray([0, 1, 1, 0, 1, 2, 2, 0], np.int32),
              "local": np.asarray([0, 1, 2, 0, 1, 2, 3, -1], np.int32),
              "counts": np.asarray([4, 3, 0], np.int32)}
    toks = rng.integers(0, V, size=(1, 8)).astype(np.int32)
    j, t = _run_both(jcfg, jp, tp, jcache, tcache, toks, mode="tree", ragged=ragged)
    _check_pass(j, t, np.s_[:, :7])
