"""The schedules of ``commit_kv`` and the flash-decode kernel, on the CPU.

The CUDA kernels (csrc/commit_kv.cu, csrc/decode_attention.cu) run only on
the card.  Their partitions of the work are modelled here in plain torch,
step for step, on seeded numpy inputs:

* ``commit_kv``: the units of work (feature slice, layer, k|v) from
  ``commit_schedule``, the CTAs that walk them (run in reversed and in
  random order), each CTA's compacted list of the entries that move, and
  every unit gathering all of its items (HOLD a thread) before it
  scatters.  Held exactly against ``kernels.ref.commit_kv_ref`` and the JAX
  package's Pallas ``commit_kv`` (interpret mode).
* flash-decode: the splits of each row's valid range from ``split_slots``,
  the 16-row head tiles (G 4 and 8 padded), the 64-key chunks of which each
  of 4 warps takes 16 keys with its own online softmax, the warps' merge,
  and the last CTA's online combine of the partials, taken in a random
  finishing order with the atomic ticket; length 0 (the mean of V) and the
  window.  Held against ``repro.kernels.ops.gqa_decode_attention`` and
  ``gqa_paged_decode_attention`` (interpret mode) in float32 to 1e-5, at
  G 4, 8 and 16.
* The split and slice rules themselves.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels.commit_kv import commit_kv as jax_commit_kv
from repro_torch.kernels.commit_kv import HOLD, MAX_ENTRIES, MAX_THREADS, THREADS_PER_SM, commit_schedule
from repro_torch.kernels.decode_attention import HEADS_PER_CTA, split_slots
from repro_torch.kernels.ops import gqa_decode_attention, gqa_paged_decode_attention, pool_commit_kv
from repro_torch.kernels.ref import commit_kv_ref, paged_gather_kv_ref

ATOL = 1e-5
NEG_INF = -1e30
SMS = 132  # the H100's SMs
WARPS, WARP_KEYS = 4, 16  # the bf16 decode kernel: warps a CTA, keys of a chunk a warp


# ------------------------------------------------------------- commit_kv ---


def commit_model(k, v, src, dst, order):
    """csrc/commit_kv.cu in plain torch, in place.  ``order`` maps the CTA
    list to the order they run in ("reversed" or a numpy Generator)."""
    L, B, smax = k.shape[:3]
    elt = k.element_size()
    vec = 16 // elt  # elements of a 16-byte vector
    fv = k.shape[3] * k.shape[4] // vec
    E = src.numel()
    width, threads, ctas = commit_schedule(L, E, fv, SMS)
    # the compacted list: the entries that move, in entry order, as lanes of a layer
    s, d = src.reshape(-1).long(), dst.reshape(-1).long()
    row = torch.arange(E) // src.shape[1]
    moves = (s != d) & (s >= 0) & (s < smax) & (d >= 0) & (d < smax)
    src_lane, dst_lane = (row * smax + s)[moves], (row * smax + d)[moves]
    M = int(moves.sum())
    data = {0: k.view(L, B * smax, fv, vec), 1: v.view(L, B * smax, fv, vec)}
    n_slices = -(-fv // width)
    n_units = n_slices * L * 2
    cta_ids = list(range(ctas))
    cta_ids = cta_ids[::-1] if order == "reversed" else list(order.permutation(ctas))
    for cta in cta_ids:
        for unit in range(cta, n_units, ctas):
            slice_, lk = unit % n_slices, unit // n_slices
            l, which = lk // 2, lk % 2
            c0 = slice_ * width
            w = min(width, fv - c0)
            items = torch.arange(M * w)
            assert M * w <= HOLD * threads  # item i: thread i % threads, register i // threads < HOLD
            e, c = items // w, c0 + items % w
            held = data[which][l, src_lane[e], c].clone()  # gather every item ...
            data[which][l, dst_lane[e], c] = held          # ... then scatter
    return k, v


def _arena(rng, L, B, smax, Hkv, hd, dtype):
    k = torch.from_numpy(rng.standard_normal((L, B, smax, Hkv, hd)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((L, B, smax, Hkv, hd)).astype(np.float32)).to(dtype)
    return k, v


def _chains(rng, B, P, smax):
    """Accepted paths: row b moves C + n_j -> C + 1 + j for strictly
    increasing n_j >= j + 1 (entry j's source may be entry j+1's
    destination) and pads with the root's identity copy; rows of the second
    half pad with one shared trash lane."""
    src = np.zeros((B, P), np.int32)
    dst = np.zeros((B, P), np.int32)
    for b in range(B):
        if b >= (B + 1) // 2:
            src[b] = dst[b] = 1  # the trash lane, identity
            continue
        C = int(rng.integers(2, smax - 2 * P - 1))
        n = int(rng.integers(1, P + 1))
        nodes = np.sort(rng.choice(np.arange(1, 2 * P + 1), n, replace=False))
        src[b], dst[b] = C, C
        src[b, :n] = C + nodes
        dst[b, :n] = C + 1 + np.arange(n)
    return src, dst


@pytest.mark.parametrize("order", ["reversed", "random"])
@pytest.mark.parametrize("L,B,P,smax,Hkv,hd,dtype", [
    (4, 3, 4, 24, 2, 16, torch.float32),     # 8 vectors a lane, 2 units of (slice, layer, k|v) a layer
    (2, 1, 6, 40, 1, 24, torch.float32),     # 6 vectors a lane
    (37, 2, 3, 20, 3, 8, torch.bfloat16),    # 3 vectors a lane in slices of 2: a partial last slice
])
def test_commit_model_matches_plain_and_jax(order, L, B, P, smax, Hkv, hd, dtype):
    rng = np.random.default_rng(L * 100 + P)
    k, v = _arena(rng, L, B, smax, Hkv, hd, dtype)
    src, dst = _chains(rng, B, P, smax)
    if B == 1:  # the paged commit's one row: the chain [2, 3, 4] and trash padding
        src[0], dst[0] = [12, 13, 14, 1, 1, 1], [11, 12, 13, 1, 1, 1]
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    want_k, want_v = pool_commit_kv(k.clone(), v.clone(), ts, td)  # kernels.ops: the plain version on the CPU
    got_k, got_v = commit_model(k.clone(), v.clone(), ts, td,
                                "reversed" if order == "reversed" else np.random.default_rng(7))
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    jk, jv = jax_commit_kv(*(jnp.asarray(a.float().numpy()) for a in (k, v)), jnp.asarray(src), jnp.asarray(dst),
                           interpret=True)
    np.testing.assert_array_equal(np.asarray(jk), want_k.float().numpy())
    np.testing.assert_array_equal(np.asarray(jv), want_v.float().numpy())


def test_commit_model_drops_identity_and_out_of_range_entries():
    rng = np.random.default_rng(3)
    k, v = _arena(rng, 3, 2, 12, 2, 8, torch.float32)
    src = torch.tensor([[3, 4, 12, -1, 6], [2, 2, 5, 9, 1]], dtype=torch.int32)
    dst = torch.tensor([[2, 3, 7, 8, 6], [1, -1, 40, 9, 0]], dtype=torch.int32)
    want_k, want_v = commit_kv_ref(k.clone(), v.clone(), src, dst)
    got_k, got_v = commit_model(k.clone(), v.clone(), src, dst, np.random.default_rng(1))
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)


@pytest.mark.parametrize("L,entries,fv,want", [
    (36, 32, 128, (16, 64, 576)),   # granite-8b's 36-layer arena: 576 units, one CTA each
    (8, 32, 64, (2, 32, 512)),      # qwen3-moe target arena, 8 layers, Hkv 4
    (23, 32, 32, (2, 32, 736)),     # qwen3-moe draft arena, 23 layers, Hkv 2
    (36, 4096, 128, (2, 1024, 264)),  # the entry cap: slices of 2 vectors (one 32-byte sector), 2 CTAs of 1024
                                      # threads an SM walk 4608 units
    (1, 1, 1, (1, 32, 2)),
])
def test_commit_schedule_rule(L, entries, fv, want):
    width, threads, ctas = got = commit_schedule(L, entries, fv, SMS)
    assert got == want
    units = -(-fv // width) * L * 2
    assert width & (width - 1) == 0 and width <= fv
    assert entries * width <= HOLD * threads and threads % 32 == 0 and threads <= MAX_THREADS
    assert ctas == min(units, SMS * (THREADS_PER_SM // threads))
    with pytest.raises(ValueError, match="entries"):
        commit_schedule(L, MAX_ENTRIES + 1, fv, SMS)


# ---------------------------------------------------------- flash-decode ---


def decode_model(q, kview, vview, lengths, window, finish_order):
    """csrc/decode_attention.cu's bf16 schedule in float32.  q (B, H, D);
    kview, vview (B, S, Hkv, D) the K/V views (a paged arena gathered
    through its table); lengths (B,).  The CTAs finish in ``finish_order``
    (a numpy Generator); the one that takes a row's last ticket combines.
    Returns (B, H, D) and the number of CTAs that wrote an output."""
    B, H, D = q.shape
    S, Hkv = kview.shape[1], kview.shape[2]
    G = H // Hkv
    P = split_slots(S)
    n_split = -(-S // P)
    scale = 1.0 / math.sqrt(D)
    out = torch.full((B, H, D), float("nan"))
    partial, writers = {}, 0
    ctas = [(b, kvh, g0, split) for b in range(B) for kvh in range(Hkv)
            for g0 in range(0, G, HEADS_PER_CTA) for split in range(n_split)]
    tickets, n_used_of = {}, {}
    for i in finish_order.permutation(len(ctas)):
        b, kvh, g0, split = ctas[i]
        ln = int(lengths[b])
        lo, hi = (max(ln - window, 0) if window else 0), min(ln, S)
        none = hi <= lo
        if none:
            lo, hi = 0, S
        s_begin = lo + split * P
        if s_begin >= hi:
            continue  # past the row's range: exits, writes nothing
        s_end, n_used = min(s_begin + P, hi), -(-(hi - lo) // P)
        heads = list(range(kvh * G + g0, kvh * G + min(G, g0 + HEADS_PER_CTA)))
        tile = torch.zeros(HEADS_PER_CTA, D)  # 16 rows, zeros past the real heads
        tile[:len(heads)] = q[b, heads]
        states = []
        for w in range(WARPS):  # warp w: keys [16 w, 16 w + 16) of every 64-key chunk, its own softmax
            m, l, acc = torch.full((HEADS_PER_CTA,), NEG_INF), torch.zeros(HEADS_PER_CTA), torch.zeros(HEADS_PER_CTA, D)
            for c0 in range(s_begin + WARP_KEYS * w, s_end, WARPS * WARP_KEYS):
                keys = torch.arange(c0, c0 + WARP_KEYS)
                kc = kview[b, keys.clamp(max=S - 1), kvh]
                vc = torch.where((keys < s_end)[:, None], vview[b, keys.clamp(max=S - 1), kvh], 0.0)
                s = torch.zeros(HEADS_PER_CTA, WARP_KEYS) if none else tile @ kc.T * scale
                s = torch.where(keys < s_end, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=1))
                alpha = torch.exp(m - m_new)
                p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new[:, None]), 0.0)
                l, acc, m = l * alpha + p.sum(dim=1), acc * alpha[:, None] + p @ vc, m_new
            states.append((m, l, acc))
        M = torch.stack([st[0] for st in states]).amax(dim=0)  # the warps' merge
        wts = [torch.exp(st[0] - M) for st in states]
        L = sum(st[1] * wt for st, wt in zip(states, wts))
        acc = sum(st[2] * wt[:, None] for st, wt in zip(states, wts))
        real = slice(0, len(heads))
        if n_used == 1:
            out[b, heads] = acc[real] / L[real].clamp_min(1e-30)[:, None]
            writers += 1
            continue
        partial[(b, kvh, g0, split)] = (M[real], L[real], acc[real])
        n_used_of[(b, kvh, g0)] = n_used
        ticket = tickets.get((b, kvh, g0), 0)
        tickets[(b, kvh, g0)] = ticket + 1
        if ticket != n_used - 1:
            continue
        # the last CTA: an online merge of every used split's partial
        m_c, l_c, a_c = torch.full((len(heads),), NEG_INF), torch.zeros(len(heads)), torch.zeros(len(heads), D)
        for sp in range(n_used):
            pm, pl, pa = partial[(b, kvh, g0, sp)]  # written before its CTA took a ticket
            m_new = torch.maximum(m_c, pm)
            old, wt = torch.exp(m_c - m_new), torch.exp(pm - m_new)
            l_c, a_c, m_c = l_c * old + pl * wt, a_c * old[:, None] + pa * wt[:, None], m_new
        out[b, heads] = a_c / l_c.clamp_min(1e-30)[:, None]
        writers += 1
    assert all(tickets[key] == used for key, used in n_used_of.items())  # every used split took one
    return out, writers


def _decode_inputs(rng, B, S, H, Hkv, D):
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("H,Hkv", [(8, 2), (8, 1), (16, 1)])  # G 4, 8 and 16
def test_decode_model_matches_jax_dense(window, H, Hkv):
    """S 384 takes 128-slot splits: rows of one split, of a chunk's end
    mid-split, of two and of three splits, and a row at length 0 (every
    split; the mean of V over S)."""
    B, S, D = 5, 384, 32
    rng = np.random.default_rng(H * 10 + Hkv + window)
    q, k, v = _decode_inputs(rng, B, S, H, Hkv, D)
    lengths = np.asarray([0, 45, 128, 250, 384], np.int32)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lengths))
    want = gqa_decode_attention(tq, tk, tv, tl, window=window)
    jout = jops.gqa_decode_attention(*(jnp.asarray(a) for a in (q, k, v, lengths)), block_k=128, window=window,
                                     interpret=True)
    np.testing.assert_allclose(want.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    got, writers = decode_model(tq[:, 0], tk, tv, tl, window, np.random.default_rng(window))
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), atol=ATOL, rtol=0)
    assert writers == B * Hkv * -(-(H // Hkv) // HEADS_PER_CTA)  # one output write per (row, head group)


@pytest.mark.parametrize("H,Hkv", [(8, 2), (16, 1)])
def test_decode_model_matches_jax_paged(H, Hkv):
    """Rows of 1..S logical slots over 16-slot blocks (S 256: two 128-slot
    splits), unmapped tails at -1 read as the trash block 0."""
    B, nb, block, D = 4, 16, 16, 32
    S = nb * block
    rng = np.random.default_rng(H + 1)
    nblk = B * nb + 1
    k = rng.standard_normal((nblk, block, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((nblk, block, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    lengths = np.asarray([1, 37, 129, S], np.int32)
    tbl = (rng.permutation(nblk - 1)[: B * nb] + 1).reshape(B, nb).astype(np.int32)
    for b, n in enumerate(lengths):
        tbl[b, -(-n // block):] = -1
    t = [torch.from_numpy(a) for a in (q, k, v, tbl, lengths)]
    want = gqa_paged_decode_attention(*t)
    jout = jops.gqa_paged_decode_attention(*(jnp.asarray(a) for a in (q, k, v, tbl, lengths)), interpret=True)
    np.testing.assert_allclose(want.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    kd, vd = paged_gather_kv_ref(t[1], t[2], t[3])
    got, _ = decode_model(t[0][:, 0], kd, vd, t[4], 0, np.random.default_rng(2))
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("S,slots", [
    (1, 128), (1000, 128), (1024, 128),  # phase 4's arena: 8 splits a row
    (2048, 256), (4096, 512),            # 8 splits a row up to S 4096
    (32768, 512),                        # decode_32k: 64 splits a row
    (100000, 512), (1 << 20, 512),       # past S 4096 the splits grow with S
])
def test_split_slots_rule(S, slots):
    got = split_slots(S)
    assert got == slots
    assert got & (got - 1) == 0 and 128 <= got <= 512  # whole 64-key chunks of the bf16 kernel
