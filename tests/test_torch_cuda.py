"""The port's CUDA kernels against their plain versions, on the card.

Each test carries the ``cuda`` marker and skips without a CUDA device, so
here on the CPU they count no pass.  This file imports no JAX, so it also
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ops import gqa_tree_attention
from repro_torch.kernels.ref import tree_attention_ref
from repro_torch.kernels.tree_attention import tree_attention
from test_torch_edge_masks import EDGE_KINDS, edge_mask

# float32: summation order only; bfloat16: one rounding of the output
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}


def _row_rel_err(out, want):
    """Largest over batch rows of max|out - want| / max|want| of the row.
    The flash-decode tests hold this to TOLERANCE: their outputs are means
    over up to thousands of slots, far below 1, where an absolute 2e-2
    would pass zeros."""
    diff = (out.float() - want.float()).abs().flatten(1).amax(dim=1)
    return (diff / want.float().abs().flatten(1).amax(dim=1)).max().item()


def _query_row_rel_err(out, want):
    """``_row_rel_err`` over query rows of (..., H, D) outputs.  The tree
    kernels' long-cache tests hold it to TOLERANCE: a row that averages
    ~30000 keys is ~0.01-0.03, where an absolute 2e-2 would pass a lost
    split."""
    return _row_rel_err(out.flatten(0, -3), want.flatten(0, -3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,Hkv,S,D,Bm", [
    (1, 7, 32, 8, 1024, 128, 1),   # target tree pass
    (2, 1, 16, 4, 1024, 128, 1),   # draft branch step
    (16, 1, 16, 4, 1024, 128, 16),  # batched draft branch step: 8 rows x K = 2, a mask per row
    (1, 8, 32, 8, 1024, 128, 1),   # batched admission prefill, target
    (1, 8, 16, 4, 1024, 128, 1),   # batched admission prefill, draft
    (3, 19, 8, 2, 1000, 64, 3),    # two query tiles, ragged key chunk, per-row mask
    (1, 16, 4, 4, 33, 128, 1),     # one full query tile, G = 1
    (1, 7, 16, 16, 1024, 64, 1),   # whisper-medium tree pass: MHA, G = 1, D 64
    (1, 7, 48, 8, 1024, 128, 1),   # internvl2-26b tree pass: G = 6, 126 score rows, the last tile part filled
    (1, 263, 48, 8, 1024, 128, 1),  # internvl2-26b prefill: 256 patches + 7 tokens, 13 query tiles
    (1, 7, 6, 2, 1024, 32, 1),     # examples/serve_speculative.py's target tree pass: 6/2 heads of 32
    (2, 1, 2, 1, 1024, 48, 1),     # its draft's branch step: 2/1 heads of 48 (3 k-steps, 48 fp32 lanes)
    (1, 12, 6, 2, 512, 32, 1),     # the example's prefill of a 12-token prompt, 512-slot cache
    (1, 7, 6, 2, 8192, 32, 1),     # D 32 split path: 4 splits and the combine
    (2, 7, 2, 1, 8192, 48, 2),     # D 48 split path, a mask per row
])
def test_tree_attention_matches_plain_version(cuda, dtype, B, T, H, Hkv, S, D, Bm):
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + T)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dt)
               for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    mask = torch.rand((Bm, T, S), generator=gen, device=cuda) < 0.4
    mask[0, T - 1] = False  # a fully masked row: the mean of V, never NaN
    before = tree_attention.launches
    out = gqa_tree_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert tree_attention.launches == before + 1
    assert out.dtype == dt and torch.isfinite(out).all()
    err = (out.float() - tree_attention_ref(q, k, v, mask).float()).abs().max().item()
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
def test_tree_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 4, 96, device=cuda)  # head_dim 96 has no instance
    k = torch.zeros(1, 8, 2, 96, device=cuda)
    mask = torch.ones(1, 2, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tree_attention(q, k, k, mask)
    q, k = q[..., :64].contiguous(), k[..., :64].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tree_attention(q.transpose(1, 2), k, k, mask)
    with pytest.raises(ValueError, match="dtype"):
        tree_attention(q.half(), k.half(), k.half(), mask)


def _paged_inputs(cuda, dtype, B, T, H, Hkv, D, block, nb, nblk, seed, unmapped=0):
    """q, a random arena, a table of distinct physical blocks (1.., block 0
    is trash) with ``unmapped`` trailing entries of each row set to -1, and
    a random mask with one fully masked row."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, T, H, D), generator=gen, device=cuda).to(dt)
    k = torch.randn((nblk, block, Hkv, D), generator=gen, device=cuda).to(dt)
    v = torch.randn((nblk, block, Hkv, D), generator=gen, device=cuda).to(dt)
    perm = torch.randperm(nblk - 1, generator=gen, device=cuda)[: B * nb] + 1
    tbl = perm.reshape(B, nb).to(torch.int32)
    if unmapped:
        tbl[:, nb - unmapped:] = -1
    mask = torch.rand((B, T, nb * block), generator=gen, device=cuda) < 0.1
    mask[0, T - 1] = False
    return q, k, v, tbl, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,Hkv,D,block,nb,unmapped", [
    (8, 7, 32, 8, 128, 64, 16, 0),   # padded target tree pass
    (8, 1, 16, 4, 128, 64, 16, 3),   # draft trunk step, unmapped tail blocks
    (3, 5, 8, 2, 64, 16, 5, 2),      # small blocks, ragged chunk edges
    (8, 7, 6, 2, 32, 64, 8, 0),      # the example target's heads (6/2 of 32), padded tree pass
    (8, 1, 2, 1, 48, 64, 8, 2),      # the example draft's heads (2/1 of 48), trunk step
    (2, 7, 6, 2, 32, 64, 80, 3),     # D 32 on 5120-slot rows: the split path
    (2, 3, 2, 1, 48, 64, 80, 3),     # D 48 on 5120-slot rows: the split path
])
def test_paged_tree_attention_matches_plain_version(cuda, dtype, B, T, H, Hkv, D, block, nb, unmapped):
    from repro_torch.kernels.ops import gqa_paged_tree_attention
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention
    from repro_torch.kernels.ref import paged_tree_attention_ref

    q, k, v, tbl, mask = _paged_inputs(cuda, dtype, B, T, H, Hkv, D, block, nb, B * nb + 4,
                                       seed=B * 100 + T, unmapped=unmapped)
    before = paged_tree_attention.launches
    out = gqa_paged_tree_attention(q, k, v, tbl, mask)
    torch.cuda.synchronize()
    assert paged_tree_attention.launches == before + 1
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    err = (out.float() - paged_tree_attention_ref(q, k, v, tbl, mask).float()).abs().max().item()
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("owners", [[0, 0, 0, 2, 2, 1, 1, 1, 1, 0], list(range(8)) * 8,
                                    [2, 2, 2, 0, 0, 0, 0, -1, -1]])  # padding lanes: zeros
@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128),
                                     (6, 2, 32),   # examples/serve_speculative.py's target heads
                                     (2, 1, 48)])  # and its draft's
def test_ragged_paged_tree_attention_matches_plain_version(cuda, dtype, owners, H, Hkv, D):
    from repro_torch.kernels.ops import gqa_ragged_tree_attention
    from repro_torch.kernels.paged_tree_attention import ragged_paged_tree_attention
    from repro_torch.kernels.ref import ragged_tree_attention_ref

    B, N, nb, block = max(owners) + 1, len(owners), 16, 64
    gen = torch.Generator(device=cuda).manual_seed(N)
    dt = getattr(torch, dtype)
    q = torch.randn((N, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B * nb + 1, block, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    tbl = (torch.randperm(B * nb, generator=gen, device=cuda) + 1).reshape(B, nb).to(torch.int32)
    tbl[:, nb - 2:] = -1  # unmapped tail blocks read the trash block
    owner = torch.tensor(owners, dtype=torch.int32, device=cuda)
    mask = torch.rand((N, nb * block), generator=gen, device=cuda) < 0.05
    mask[max(i for i, o in enumerate(owners) if o >= 0)] = False  # fully masked: the mean of V
    before = ragged_paged_tree_attention.launches
    out = gqa_ragged_tree_attention(q, k, v, tbl, owner, mask)
    torch.cuda.synchronize()
    assert ragged_paged_tree_attention.launches == before + 1
    assert torch.isfinite(out).all() and not out[owner < 0].any()
    err = (out.float() - ragged_tree_attention_ref(q, k, v, tbl, owner, mask).float()).abs().max().item()
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_commit_kv_chain_hazard_matches_plain_version(cuda, dtype):
    """Entry j's source is entry j+1's destination (the accepted path
    [2, 3, 4] moves C+2 -> C+1, C+3 -> C+2, C+4 -> C+3) and several rows
    pad with identity copies of one shared trash lane: the kernel must equal
    gather-then-scatter exactly."""
    from repro_torch.kernels.commit_kv import commit_kv
    from repro_torch.kernels.ops import pool_commit_kv
    from repro_torch.kernels.ref import commit_kv_ref

    gen = torch.Generator(device=cuda).manual_seed(5)
    dt = getattr(torch, dtype)
    k = torch.randn((36, 1, 17 * 64, 8, 128), generator=gen, device=cuda).to(dt)
    v = torch.randn_like(k)
    src = torch.zeros((1, 32), dtype=torch.int32, device=cuda)
    dst = torch.zeros_like(src)
    for row in range(8):  # 8 rows x P = 4 entries, flattened row-major as the paged commit does
        base = (row + 1) * 64 + 10
        e = row * 4
        if row < 5:
            src[0, e:e + 3] = torch.tensor([base + 2, base + 3, base + 4])
            dst[0, e:e + 3] = torch.tensor([base + 1, base + 2, base + 3])
            src[0, e + 3] = dst[0, e + 3] = base  # padding: the root's identity copy
        else:
            src[0, e:e + 4] = dst[0, e:e + 4] = 7  # idle rows: one shared trash lane
    want_k, want_v = commit_kv_ref(k.clone(), v.clone(), src, dst)
    before = commit_kv.launches
    got_k, got_v = pool_commit_kv(k, v, src, dst)
    torch.cuda.synchronize()
    assert commit_kv.launches == before + 1
    assert got_k.data_ptr() == k.data_ptr()  # in place
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)


@pytest.mark.cuda
def test_commit_kv_moves_nothing_for_identity_or_out_of_range_entries(cuda):
    """The contract the kernel shares with its plain version: entries with
    src == dst or an index outside [0, Smax) move nothing."""
    from repro_torch.kernels.commit_kv import commit_kv
    from repro_torch.kernels.ref import commit_kv_ref

    gen = torch.Generator(device=cuda).manual_seed(6)
    k = torch.randn((3, 2, 12, 2, 8), generator=gen, device=cuda)
    v = torch.randn_like(k)
    src = torch.tensor([[3, 4, 12, -1, 6], [2, 2, 5, 9, 1]], dtype=torch.int32, device=cuda)
    dst = torch.tensor([[2, 3, 7, 8, 6], [1, -1, 40, 9, 0]], dtype=torch.int32, device=cuda)
    want_k, want_v = commit_kv_ref(k.clone(), v.clone(), src, dst)
    got_k, got_v = commit_kv(k, v, src, dst)
    torch.cuda.synchronize()
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)


# ------------------------------------------- MoE head shapes (qwen3-moe-235b-a22b) ---


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,Hkv", [
    (1, 7, 64, 4),   # target tree pass, G = 16
    (16, 1, 32, 2),  # draft branch step, 8 rows x K = 2
])
def test_tree_attention_at_moe_heads(cuda, dtype, B, T, H, Hkv):
    gen = torch.Generator(device=cuda).manual_seed(H + T)
    dt = getattr(torch, dtype)
    q = torch.randn((B, T, H, 128), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B, 1024, Hkv, 128), generator=gen, device=cuda).to(dt) for _ in range(2))
    mask = torch.rand((B, T, 1024), generator=gen, device=cuda) < 0.05
    mask[0, T - 1] = False
    out = tree_attention(q, k, v, mask)
    torch.cuda.synchronize()
    err = (out.float() - tree_attention_ref(q, k, v, mask).float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= TOLERANCE[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,Hkv", [(7, 64, 4), (1, 32, 2), (2, 32, 2)])
def test_paged_and_ragged_attention_at_moe_heads(cuda, dtype, T, H, Hkv):
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention
    from repro_torch.kernels.ref import paged_tree_attention_ref, ragged_tree_attention_ref

    q, k, v, tbl, mask = _paged_inputs(cuda, dtype, 8, T, H, Hkv, 128, 64, 16, 8 * 16 + 1, seed=H + T, unmapped=2)
    out = paged_tree_attention(q, k, v, tbl, mask)
    torch.cuda.synchronize()
    err = (out.float() - paged_tree_attention_ref(q, k, v, tbl, mask).float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= TOLERANCE[dtype], err
    owner = torch.arange(8, dtype=torch.int32, device=cuda).repeat_interleave(T)
    owner[-1] = -1  # a padding lane
    qn, mn = q.reshape(8 * T, H, 128), mask.reshape(8 * T, -1)
    out = ragged_paged_tree_attention(qn, k, v, tbl, owner, mn)
    torch.cuda.synchronize()
    err = (out.float() - ragged_tree_attention_ref(qn, k, v, tbl, owner, mn).float()).abs().max().item()
    assert torch.isfinite(out).all() and not out[-1].any() and err <= TOLERANCE[dtype], err


# ------------------------------------------------------------ flash-decode ---


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (6, 1000, 32, 8, 128),   # granite heads, G = 4, S not a chunk multiple
    (4, 4096, 64, 4, 128),   # qwen3-moe heads, G = 16
    (3, 257, 4, 4, 64),      # G = 1
    (3, 300, 12, 2, 64),     # G = 6 (a CTA of 8 heads, 2 idle)
    (2, 640, 64, 2, 128),    # G = 32: two CTAs of 16 heads per KV head
    (5, 700, 6, 2, 32),      # examples/serve_speculative.py's target heads: D 32, G 3
    (5, 700, 2, 1, 48),      # its draft's: D 48 (an odd k-step; fp32 lanes 24-31 own no dim)
    (4, 4096, 10, 1, 256),   # recurrentgemma-2b's heads: D 256, G 10, a 4096-slot cache
])
def test_decode_attention_matches_plain_version(cuda, dtype, window, B, S, H, Hkv, D):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ops import gqa_decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(S + H)
    dt = getattr(torch, dtype)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    lengths = torch.tensor(([0, 1, S, S // 3, 33, S - 5] * B)[:B], dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = gqa_decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dt and torch.isfinite(out).all()
    err = _row_rel_err(out, decode_attention_ref(q, k, v, lengths, window))
    assert err <= TOLERANCE[dtype], err
    # length 0: the mean of V over all S slots
    mean_v = v[0].float().mean(dim=0).repeat_interleave(H // Hkv, dim=0)
    assert _row_rel_err(out[:1, 0], mean_v[None]) <= TOLERANCE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("H,Hkv,D,block", [(32, 8, 128, 64), (64, 4, 128, 64), (8, 8, 64, 16), (16, 2, 64, 32),
                                            (6, 2, 32, 16), (2, 1, 48, 16), (10, 1, 256, 64)])
def test_paged_decode_attention_matches_plain_version(cuda, dtype, window, H, Hkv, D, block):
    """Rows of length 0, 1, a partial block, a full row, and a row whose
    tail blocks are unmapped (-1: the trash block)."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.ops import gqa_paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref

    B, nb = 5, 12
    S = nb * block
    gen = torch.Generator(device=cuda).manual_seed(H * block + window)
    dt = getattr(torch, dtype)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B * nb + 1, block, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    tbl = (torch.randperm(B * nb, generator=gen, device=cuda) + 1).reshape(B, nb).to(torch.int32)
    lengths = torch.tensor([0, 1, block + 5, S, 3 * block], dtype=torch.int32, device=cuda)
    tbl[0, 1:] = -1
    tbl[4, 3:] = -1
    before = paged_decode_attention.launches
    out = gqa_paged_decode_attention(q, k, v, tbl, lengths, window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert out.dtype == dt and torch.isfinite(out).all()
    err = _row_rel_err(out, paged_decode_attention_ref(q, k, v, tbl, lengths, window))
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
def test_decode_attention_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.decode_attention import decode_attention

    q = torch.zeros(2, 1, 4, 96, device=cuda)  # head_dim 96 has no instance
    k = torch.zeros(2, 8, 2, 96, device=cuda)
    ln = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, k, k, ln)
    q, k = q[..., :64].contiguous(), k[..., :64].contiguous()
    with pytest.raises(ValueError, match="lengths"):
        decode_attention(q, k, k, ln.long())
    with pytest.raises(ValueError, match="on cpu"):
        decode_attention(q.cpu(), k.cpu(), k.cpu(), ln.cpu())


# ------------------------------------------- the redesigned tree kernels' edges ---


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("B,T,H,Hkv,S,D,Bm", [
    (1, 7, 32, 8, 1024, 128, 1),   # G 4, the target tree pass
    (2, 17, 16, 1, 1024, 128, 2),  # G 16: tiles of 8 query rows, a mask per row
    (3, 33, 4, 4, 512, 64, 3),     # G 1: tiles of 32 query rows
    (2, 1, 64, 4, 1000, 128, 1),   # G 16, one query row, S not a chunk multiple, one mask for B 2
])
def test_tree_attention_at_mask_edges(cuda, dtype, kind, B, T, H, Hkv, S, D, Bm):
    gen = torch.Generator(device=cuda).manual_seed(T * 100 + H)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dt)
               for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    mask = torch.as_tensor(edge_mask(kind, Bm, T, S, seed=T), device=cuda)
    before = tree_attention.launches
    out = tree_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert tree_attention.launches == before + 1
    assert out.dtype == dt and torch.isfinite(out).all()
    err = (out.float() - tree_attention_ref(q, k, v, mask).float()).abs().max().item()
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128), (64, 4, 128),
                                     (6, 2, 32), (2, 1, 48)])  # examples/serve_speculative.py's heads
@pytest.mark.parametrize("full_row", [False, True])
def test_tree_attention_long_cache_splits(cuda, dtype, H, Hkv, D, full_row):
    """S = 32768 takes the split path (16 splits of 2048 slots and a
    combine): a (2, 2, 2) target pass after 30000 committed tokens, with or
    without a fully masked row (the combine's mean of V).  Each query row is
    held to TOLERANCE x its own largest |output|."""
    gen = torch.Generator(device=cuda).manual_seed(H)
    dt = getattr(torch, dtype)
    S, T = 32768, 7
    q = torch.randn((1, T, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((1, S, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    mask = torch.as_tensor(edge_mask("runs straddling chunk edges", 1, T, S, prefix=30000), device=cuda)
    if full_row:
        mask[0, 2] = False
    out = tree_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    want = tree_attention_ref(q, k, v, mask)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOLERANCE[dtype], err
    rel = _query_row_rel_err(out, want)
    assert rel <= TOLERANCE[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("B,T,H,Hkv,D,block,nb,unmapped,Bm", [
    (4, 7, 32, 8, 128, 64, 16, 3, 4),   # padded target pass, unmapped tails
    (2, 17, 64, 4, 64, 16, 8, 1, 1),    # G 16, 16-slot blocks, one mask for both rows
])
def test_paged_tree_attention_at_mask_edges(cuda, dtype, kind, B, T, H, Hkv, D, block, nb, unmapped, Bm):
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention
    from repro_torch.kernels.ref import paged_tree_attention_ref

    q, k, v, tbl, _ = _paged_inputs(cuda, dtype, B, T, H, Hkv, D, block, nb, B * nb + 2, seed=T + nb,
                                    unmapped=unmapped)
    mask = torch.as_tensor(edge_mask(kind, Bm, T, nb * block, seed=B), device=cuda)
    out = paged_tree_attention(q, k, v, tbl, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out.float() - paged_tree_attention_ref(q, k, v, tbl, mask).float()).abs().max().item()
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("owners,H,Hkv", [
    ([0] * 20 + [1] * 3 + [0] * 5 + [-1] * 4, 64, 4),  # G 16 (tiles of 8): a run over 3 tiles, 0 recurs
    ([2] * 40 + [1] * 7 + [2] * 2 + [-1] * 15, 32, 8),  # G 4 (tiles of 32): a run of 40
    ([0, 1] * 9 + [-1, 1, -1], 8, 8),                    # G 1: runs of one node, padding between
])
def test_ragged_paged_tree_attention_owner_runs(cuda, dtype, owners, H, Hkv):
    from repro_torch.kernels.paged_tree_attention import ragged_paged_tree_attention
    from repro_torch.kernels.ref import ragged_tree_attention_ref

    B, N, nb, block, D = max(owners) + 1, len(owners), 16, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(N + H)
    dt = getattr(torch, dtype)
    q = torch.randn((N, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B * nb + 1, block, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    tbl = (torch.randperm(B * nb, generator=gen, device=cuda) + 1).reshape(B, nb).to(torch.int32)
    tbl[:, nb - 3:] = -1
    owner = torch.tensor(owners, dtype=torch.int32, device=cuda)
    mask = torch.as_tensor(edge_mask("fully masked row in a tile", 1, N, nb * block, seed=N)[0], device=cuda)
    mask[3] |= torch.as_tensor(edge_mask("runs straddling chunk edges", 1, 1, nb * block)[0, 0], device=cuda)
    out = ragged_paged_tree_attention(q, k, v, tbl, owner, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and not out[owner < 0].any()
    err = (out.float() - ragged_tree_attention_ref(q, k, v, tbl, owner, mask).float()).abs().max().item()
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128),
                                     (6, 2, 32), (2, 1, 48)])  # examples/serve_speculative.py's heads
def test_paged_and_ragged_attention_long_rows_split(cuda, dtype, H, Hkv, D):
    """Rows of 512 64-slot blocks (32768 slots) take the split path: a
    padded target pass over 2 rows (one with unmapped tail blocks, one
    fully masked row), then the ragged pass over both owners and padding.
    Each query row is held to TOLERANCE x its own largest |output|."""
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention
    from repro_torch.kernels.ref import paged_tree_attention_ref, ragged_tree_attention_ref

    B, T, block, nb = 2, 7, 64, 512
    q, k, v, tbl, _ = _paged_inputs(cuda, dtype, B, T, H, Hkv, D, block, nb, B * nb + 1, seed=3)
    tbl[1, 400:] = -1
    mask = torch.as_tensor(edge_mask("runs straddling chunk edges", B, T, nb * block, prefix=25000), device=cuda)
    mask[1, 4] = False
    out = paged_tree_attention(q, k, v, tbl, mask)
    torch.cuda.synchronize()
    want = paged_tree_attention_ref(q, k, v, tbl, mask)
    err = (out.float() - want.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= TOLERANCE[dtype], err
    rel = _query_row_rel_err(out, want)
    assert rel <= TOLERANCE[dtype], rel
    owner = torch.tensor([0] * T + [1] * T + [-1, -1], dtype=torch.int32, device=cuda)
    qn = torch.cat([q.reshape(B * T, H, D), q[0, :2]])
    mn = torch.cat([mask.reshape(B * T, -1), mask[0, :2]])
    out = ragged_paged_tree_attention(qn, k, v, tbl, owner, mn)
    torch.cuda.synchronize()
    want = ragged_tree_attention_ref(qn, k, v, tbl, owner, mn)
    err = (out.float() - want.float()).abs().max().item()
    assert torch.isfinite(out).all() and not out[-2:].any() and err <= TOLERANCE[dtype], err
    rel = _query_row_rel_err(out[:-2], want[:-2])  # the padding lanes are zeros: no scale of their own
    assert rel <= TOLERANCE[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_kernels_at_head_dim_256(cuda, dtype):
    """recurrentgemma-2b's local attention (H 10, Hkv 1, head_dim 256: 64
    score rows a CTA) under its 2048-slot window, with a fully masked row,
    through kernels 1-3: first the largest shared-memory layout of one key
    range (S 4096, 16-slot blocks; the chunks below the window are dead),
    then a smaller one (S 1024), then the largest again.  Each output is
    held to TOLERANCE, and each query row to TOLERANCE x its own largest
    |output|."""
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention
    from repro_torch.kernels.ref import paged_tree_attention_ref, ragged_tree_attention_ref
    from repro_torch.models.cache import attn_mask_from_pos

    B, T, H, Hkv, D, block, window = 2, 5, 10, 1, 256, 16, 2048
    for i, S in enumerate((4096, 1024, 4096)):
        nb = S // block
        q, k, v, tbl, _ = _paged_inputs(cuda, dtype, B, T, H, Hkv, D, block, nb, B * nb + 2, seed=S + i)
        kd, vd = (torch.randn((B, S, Hkv, D), device=cuda, generator=torch.Generator(device=cuda).manual_seed(i))
                  .to(q.dtype) for _ in range(2))
        pos = torch.arange(S, device=cuda)[None].expand(B, S)  # a full ring: position s in slot s
        q_pos = torch.stack([torch.arange(S - T, S, device=cuda), torch.arange(S - 2 * T, S - T, device=cuda)])
        mask = attn_mask_from_pos(pos, q_pos, window)[:, 0].contiguous()  # (B, T, S)
        mask[0, T - 1] = False  # a fully masked row: the mean of V
        checks = [(tree_attention(q, kd, vd, mask), tree_attention_ref(q, kd, vd, mask)),
                  (paged_tree_attention(q, k, v, tbl, mask), paged_tree_attention_ref(q, k, v, tbl, mask))]
        owner = torch.tensor([0] * T + [1] * T + [-1], dtype=torch.int32, device=cuda)
        qn, mn = torch.cat([q.reshape(B * T, H, D), q[0, :1]]), torch.cat([mask.reshape(B * T, S), mask[0, :1]])
        out = ragged_paged_tree_attention(qn, k, v, tbl, owner, mn)
        assert not out[-1].any()
        checks.append((out[:-1], ragged_tree_attention_ref(qn, k, v, tbl, owner, mn)[:-1]))
        torch.cuda.synchronize()
        for out, want in checks:
            assert out.dtype == q.dtype and torch.isfinite(out).all()
            err = (out.float() - want.float()).abs().max().item()
            assert err <= TOLERANCE[dtype], (S, err)
            rel = _query_row_rel_err(out, want)
            assert rel <= TOLERANCE[dtype], (S, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,C,D", [
    (2, 13, 1024, 40, 256),   # 3 query tiles of 6 rows a batch row, the last one partial
    (2, 8, 4096, 3000, 256),  # an 8-token admission past the window: 2 tiles, dead chunks below it
    (1, 2600, 4096, 0, 256),  # a 2600-token prefill into an empty 4096-slot ring: 434 tiles
    (1, 2600, 4096, 0, 128),  # the same prefill through the draft's heads (G 10 at D 128: tiles of 12)
])
def test_tree_kernels_many_query_tiles_under_the_window(cuda, dtype, B, T, S, C, D):
    """recurrentgemma-2b's local attention (H 10, Hkv 1) with several query
    tiles in one batch row, each with its own window of live chunks: T new
    tokens after C + 9 b committed ones in row b, the mask made by the
    cache's own function, through kernels 1 and 2 (64-slot blocks).  Each
    output is held to TOLERANCE, and each query row to TOLERANCE x its own
    largest |output|."""
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention
    from repro_torch.kernels.ref import paged_tree_attention_ref
    from repro_torch.models.cache import attn_mask_from_pos

    H, Hkv, block, window = 10, 1, 64, 2048
    nb = S // block
    q, k, v, tbl, _ = _paged_inputs(cuda, dtype, B, T, H, Hkv, D, block, nb, B * nb + 1, seed=T + D)
    kd, vd = (torch.randn((B, S, Hkv, D), device=cuda, generator=torch.Generator(device=cuda).manual_seed(i))
              .to(q.dtype) for i in range(2))
    lengths = torch.tensor([C + 9 * b for b in range(B)], device=cuda)
    slot = torch.arange(S, device=cuda)[None]
    pos = torch.where(slot < (lengths + T)[:, None], slot, -1)
    q_pos = lengths[:, None] + torch.arange(T, device=cuda)
    mask = attn_mask_from_pos(pos, q_pos, window)[:, 0].contiguous()  # (B, T, S)
    checks = [(tree_attention(q, kd, vd, mask), tree_attention_ref(q, kd, vd, mask)),
              (paged_tree_attention(q, k, v, tbl, mask), paged_tree_attention_ref(q, k, v, tbl, mask))]
    torch.cuda.synchronize()
    for out, want in checks:
        assert out.dtype == q.dtype and torch.isfinite(out).all()
        err = (out.float() - want.float()).abs().max().item()
        assert err <= TOLERANCE[dtype], err
        rel = _query_row_rel_err(out, want)
        assert rel <= TOLERANCE[dtype], rel


# ------------------------------- the one-launch flash-decode and the one-wave commit ---


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8192])
@pytest.mark.parametrize("H,Hkv,D", [
    (32, 8, 128),  # granite-8b heads, G 4: 12 padded rows of the bf16 tile
    (64, 8, 128),  # Llama-3 70B heads, G 8
    (64, 4, 128),  # qwen3-moe heads, G 16: a full tile
    (16, 4, 64),   # G 4 at D 64
    (32, 2, 64),   # G 16 at D 64
    (6, 2, 32),    # D 32, G 3
    (2, 1, 48),    # D 48, G 2
    (10, 1, 256),  # D 256, recurrentgemma-2b's G 10
])
def test_decode_attention_mixes_one_split_and_many_split_rows(cuda, dtype, window, H, Hkv, D):
    """S 16384 (512-slot splits): in one batch a row at length 0 (every split,
    the mean of V), rows inside one split (the CTA writes the output), rows
    that end mid-chunk over two or many splits (the last CTA's combine), a
    full row; with a window of 8192 the long rows start mid-cache.  A second
    call on the same inputs gives the same output: the tickets reset."""
    from repro_torch.kernels.decode_attention import decode_attention, split_slots
    from repro_torch.kernels.ref import decode_attention_ref

    S = 16384
    assert split_slots(S) == 512
    gen = torch.Generator(device=cuda).manual_seed(H * D + window)
    dt = getattr(torch, dtype)
    lengths = torch.tensor([0, 1, 45, 500, 513, 9000 + 7, 16383, S], dtype=torch.int32, device=cuda)
    B = lengths.numel()
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    before = decode_attention.launches
    out = decode_attention(q, k, v, lengths, window=window)
    again = decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert out.dtype == dt and torch.isfinite(out).all()
    assert torch.equal(out, again)
    err = _row_rel_err(out, decode_attention_ref(q, k, v, lengths, window))
    assert err <= TOLERANCE[dtype], err
    mean_v = v[0].float().mean(dim=0).repeat_interleave(H // Hkv, dim=0)
    assert _row_rel_err(out[:1, 0], mean_v[None]) <= TOLERANCE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_repeats_on_many_split_rows(cuda, dtype):
    """Paged rows of 512 16-slot blocks (8192 slots: 16 splits of 512) with
    unmapped tails: two calls in a row give the same output."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref

    B, H, Hkv, D, block, nb = 4, 64, 8, 128, 16, 512
    gen = torch.Generator(device=cuda).manual_seed(11)
    dt = getattr(torch, dtype)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B * nb + 1, block, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    tbl = (torch.randperm(B * nb, generator=gen, device=cuda) + 1).reshape(B, nb).to(torch.int32)
    lengths = torch.tensor([0, 77, 4099, 8192], dtype=torch.int32, device=cuda)
    tbl[1, 5:] = -1
    tbl[2, 257:] = -1
    out = paged_decode_attention(q, k, v, tbl, lengths)
    again = paged_decode_attention(q, k, v, tbl, lengths)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.isfinite(out).all()
    err = _row_rel_err(out, paged_decode_attention_ref(q, k, v, tbl, lengths))
    assert err <= TOLERANCE[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_at_recurrentgemma_window(cuda, dtype):
    """recurrentgemma-2b's local attention: D 256, H 10 over Hkv 1, its
    2048-slot window on a 4096-slot cache, dense and paged (64-slot blocks,
    unmapped tails); rows shorter than, equal to and past the window."""
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.ref import decode_attention_ref, paged_decode_attention_ref

    B, S, H, Hkv, D, window, block = 5, 4096, 10, 1, 256, 2048, 64
    gen = torch.Generator(device=cuda).manual_seed(256)
    dt = getattr(torch, dtype)
    lengths = torch.tensor([0, 700, 2048, 2600, S], dtype=torch.int32, device=cuda)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    out = decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dt and torch.isfinite(out).all()
    assert _row_rel_err(out, decode_attention_ref(q, k, v, lengths, window)) <= TOLERANCE[dtype]
    nb = S // block
    tbl = (torch.randperm(B * nb, generator=gen, device=cuda) + 1).reshape(B, nb).to(torch.int32)
    tbl[1, 11:] = -1
    tbl[3, 41:] = -1
    ka, va = (x.reshape(B * nb, block, Hkv, D) for x in (k, v))
    ka, va = (torch.cat([torch.zeros_like(x[:1]), x]) for x in (ka, va))  # block 0: trash
    out = paged_decode_attention(q, ka, va, tbl, lengths, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dt and torch.isfinite(out).all()
    err = _row_rel_err(out, paged_decode_attention_ref(q, ka, va, tbl, lengths, window))
    assert err <= TOLERANCE[dtype], err


def _commit_chains(seed, B, P, smax):
    """B rows x P entries of accepted paths: row b's strictly increasing nodes
    n_j >= j + 1 move C + n_j -> C + 1 + j (entry j's source may be entry
    j+1's destination), the rest of the row pads with the root's identity
    copy C -> C, as make_pool_commit_step stages them."""
    src = torch.empty((B, P), dtype=torch.int32)
    dst = torch.empty((B, P), dtype=torch.int32)
    g = torch.Generator().manual_seed(seed)
    for b in range(B):
        C = int(torch.randint(0, smax - 2 * P - 1, (1,), generator=g))
        n = int(torch.randint(0, P + 1, (1,), generator=g))
        nodes = torch.randperm(2 * P, generator=g)[:n].sort().values + 1
        src[b] = C
        dst[b] = C
        src[b, :n] = C + nodes.to(torch.int32)
        dst[b, :n] = C + 1 + torch.arange(n, dtype=torch.int32)
    return src, dst


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,P,smax,Hkv,hd,dtype", [
    (2, 64, 64, 160, 2, 64, "bfloat16"),  # B * P = 4096, the entry cap
    (1, 8, 4, 96, 8, 128, "bfloat16"),    # L 1
    (80, 3, 5, 40, 7, 4, "float32"),      # 7 vectors a lane in slices of 2: the last slice is partial
    (36, 1, 32, 17 * 64, 8, 128, "bfloat16"),  # the 36-layer arena as one row
])
def test_commit_kv_at_the_cap_one_layer_and_partial_slices(cuda, L, B, P, smax, Hkv, hd, dtype):
    from repro_torch.kernels.commit_kv import HOLD, MAX_ENTRIES, commit_kv, commit_schedule
    from repro_torch.kernels.ref import commit_kv_ref

    dt = getattr(torch, dtype)
    fv = Hkv * hd * torch.empty((), dtype=dt).element_size() // 16
    width, threads, _ = commit_schedule(L, B * P, fv, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert B * P * width <= HOLD * threads and B * P <= MAX_ENTRIES
    gen = torch.Generator(device=cuda).manual_seed(L * B + P)
    k = torch.randn((L, B, smax, Hkv, hd), generator=gen, device=cuda).to(dt)
    v = torch.randn_like(k)
    src, dst = (t.to(cuda) for t in _commit_chains(L + P, B, P, smax))
    want_k, want_v = commit_kv_ref(k.clone(), v.clone(), src, dst)
    before = commit_kv.launches
    commit_kv(k, v, src, dst)
    torch.cuda.synchronize()
    assert commit_kv.launches == before + 1
    assert torch.equal(k, want_k) and torch.equal(v, want_v)


@pytest.mark.cuda
def test_commit_kv_all_identity_is_a_no_op(cuda):
    from repro_torch.kernels.commit_kv import commit_kv

    gen = torch.Generator(device=cuda).manual_seed(9)
    k = torch.randn((4, 2, 64, 8, 128), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn_like(k)
    k0, v0 = k.clone(), v.clone()
    slots = torch.randint(0, 64, (2, 16), generator=gen, device=cuda).to(torch.int32)
    commit_kv(k, v, slots, slots.clone())
    torch.cuda.synchronize()
    assert torch.equal(k, k0) and torch.equal(v, v0)


def _tree_smem_bytes(dtype, D, split_slots):
    """Dynamic shared memory of a dense tree-body launch: the host's copy of
    ``make_layout`` in csrc/tree_attention_body.cuh."""
    elt = 2 if dtype == "bfloat16" else 4
    slots = 2 * (4 if elt == 2 else 1)  # stages x chunks a stage
    a16 = lambda x: (x + 15) & ~15
    n_chunk = split_slots // 32
    total = a16(slots * 2 * 32 * (D + 16 // elt) * elt)
    if elt == 4:
        total += a16(8 * 16 * D * 4) + a16(8 * 16 * 32 * 4)
    return total + a16(32 * n_chunk * 4) + a16((n_chunk // 32 + 1) * 4 + n_chunk * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_attention_above_48kb_of_shared_memory(cuda, dtype):
    """Launches past the 48 KB default set the shared-memory attribute on
    every launch (it holds for the current device only): the largest
    layout, a smaller one, then the largest again, each against the plain
    version."""
    from repro_torch.kernels.tree_attention import launch_schedule

    dt = getattr(torch, dtype)
    for S, D in ((4096, 128), (64, 64), (4096, 128)):
        _, _, split_slots, _ = launch_schedule(32, 8, S)
        assert _tree_smem_bytes(dtype, D, split_slots) > 48 * 1024
        gen = torch.Generator(device=cuda).manual_seed(S + D)
        q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dt)
                   for shape in ((1, 7, 32, D), (1, S, 8, D), (1, S, 8, D)))
        mask = torch.rand((1, 7, S), generator=gen, device=cuda) < 0.5
        before = tree_attention.launches
        out = tree_attention(q, k, v, mask)
        torch.cuda.synchronize()
        assert tree_attention.launches == before + 1
        err = (out.float() - tree_attention_ref(q, k, v, mask).float()).abs().max().item()
        assert err <= TOLERANCE[dtype], (S, D, err)


def _selector_case(n=24):
    import numpy as np

    from repro_torch.core.selector import FixedSpace, SelectorConfig

    actions = [(1, 3, 0), (2, 1, 1), (2, 2, 2), (4, 1, 1)]
    cfg = SelectorConfig(hidden_p=4096, hidden_q=2048, dropout=0.0, space=FixedSpace(actions))
    rng = np.random.default_rng(0)
    traces = {"h_prev_p": rng.normal(size=(n, 4096)), "h_prev_q": rng.normal(size=(n, 2048)),
              "h_cur_q": rng.normal(size=(n, 2048)), "scalars": rng.normal(size=(n, 11)),
              "eff": rng.uniform(1, 4, size=(n, 4)), "time": rng.uniform(1e-3, 5e-3, size=(n, 4))}
    return cfg, {k: v.astype(np.float32) for k, v in traces.items()}


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_selector_on_the_card_matches_the_cpu(cuda, no_tf32):
    from repro_torch.core.selector import init_selector, select_action, selector_logits
    from repro_torch.training.optim import tree_map

    cfg, traces = _selector_case()
    params = init_selector(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = tree_map(lambda p: p.to(cuda), params)
    feats = [torch.as_tensor(traces[k]) for k in ("h_prev_p", "h_prev_q", "h_cur_q", "scalars")]
    want = selector_logits(params, *feats)
    got = selector_logits(gpu, *(f.to(cuda) for f in feats))
    assert got.device.type == "cuda"
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    for b in range(4):
        one = [f[b:b + 1] for f in feats]
        assert select_action(gpu, *(f.to(cuda) for f in one), cfg.space) == select_action(params, *one, cfg.space)


@pytest.mark.cuda
def test_train_selector_step_on_the_card_matches_the_cpu(cuda, no_tf32, monkeypatch):
    """One train_selector step from the same init: the loss, the gradients
    and the updated parameters.  AdamW's first update is lr g / (|g| + eps),
    so an entry whose gradient cancels to ~0 may step either way on either
    device: those (|g| < 1e-6 on the CPU) are held to 2 lr instead."""
    import numpy as np

    from repro_torch.core.selector import init_selector, selector_loss
    from repro_torch.training import selector_train
    from repro_torch.training.optim import tree_leaves, tree_map

    cfg, traces = _selector_case()
    params = init_selector(cfg, torch.Generator().manual_seed(1), "cpu")
    monkeypatch.setattr(selector_train, "init_selector", lambda c, g, device: tree_map(lambda p: p.to(device), params))
    lr = 1e-3
    runs = {d: selector_train.train_selector(traces, cfg, steps=1, batch=16, lr=lr, seed=3, device=d)
            for d in ("cpu", cuda)}
    assert abs(runs["cpu"][1][0] - runs[cuda][1][0]) <= 1e-5
    # the step's minibatch, as train_selector draws it, and its gradients on the CPU
    idx = np.random.default_rng(3).integers(0, 24, size=16)
    batch = {k: torch.as_tensor(v[idx]) for k, v in traces.items()}
    batch["base"] = torch.full((16,), selector_train.best_static_action(traces))
    batch["scalars"] = torch.as_tensor(selector_train._standardize(traces["scalars"])[idx])
    leaves = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss = selector_loss(leaves, batch)
    loss.backward()
    assert abs(float(loss.detach()) - runs["cpu"][1][0]) <= 1e-6
    for p_cpu, p_gpu, g in zip(tree_leaves(runs["cpu"][0]), tree_leaves(runs[cuda][0]),
                               tree_leaves(tree_map(lambda p: p.grad, leaves))):
        assert p_gpu.device.type == "cuda"
        diff = (p_gpu.cpu() - p_cpu).abs()
        settled = g.abs() >= 1e-6
        assert diff[settled].max().item() <= 1e-5 if settled.any() else True
        assert diff.max().item() <= 2 * lr


def _to_cuda(tree, device):
    return {k: _to_cuda(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
def test_every_wrapper_refuses_a_tensor_that_requires_grad(cuda):
    """The hand-written kernels have no backward: each wrapper raises on a
    CUDA tensor that requires grad while grad mode is on, and launches
    nothing (no detach, no plain fallback)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.commit_kv import commit_kv
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention

    def g(*shape):
        return torch.randn(*shape, device=cuda).requires_grad_()

    tbl = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    mask = torch.ones(1, 2, 16, dtype=torch.bool, device=cuda)
    calls = {
        "tree_attention": (tree_attention, lambda: ops.gqa_tree_attention(g(1, 2, 4, 64), g(1, 16, 1, 64),
                                                                          g(1, 16, 1, 64), mask)),
        "paged_tree_attention": (paged_tree_attention, lambda: ops.gqa_paged_tree_attention(
            g(1, 2, 4, 64), g(3, 8, 1, 64), g(3, 8, 1, 64), tbl, mask)),
        "ragged_paged_tree_attention": (ragged_paged_tree_attention, lambda: ops.gqa_ragged_tree_attention(
            g(2, 4, 64), g(3, 8, 1, 64), g(3, 8, 1, 64), tbl, torch.zeros(2, dtype=torch.int32, device=cuda),
            mask[0])),
        "commit_kv": (commit_kv, lambda: ops.pool_commit_kv(
            g(1, 1, 16, 1, 64), g(1, 1, 16, 1, 64), *(torch.zeros(1, 2, dtype=torch.int32, device=cuda),) * 2)),
        "decode_attention": (decode_attention, lambda: ops.gqa_decode_attention(
            g(1, 1, 4, 64), g(1, 16, 1, 64), g(1, 16, 1, 64), torch.full((1,), 16, dtype=torch.int32, device=cuda))),
        "paged_decode_attention": (paged_decode_attention, lambda: ops.gqa_paged_decode_attention(
            g(1, 1, 4, 64), g(3, 8, 1, 64), g(3, 8, 1, 64), tbl, torch.full((1,), 16, dtype=torch.int32,
                                                                            device=cuda))),
    }
    for name, (kernel, call) in calls.items():
        before = kernel.launches
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert kernel.launches == before, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b", "recurrentgemma-2b"])
def test_train_forward_on_the_card_launches_no_kernel_and_matches_the_cpu(cuda, no_tf32, arch):
    """``forward(..., train=True)`` on the card takes the plain attention:
    no hand-written kernel launches, and the gradients of ``loss_and_grads``
    equal the CPU's (float32, within 1e-4 of each leaf's largest |value|)."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.commit_kv import commit_kv
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention
    from repro_torch.models.transformer import forward, init_params, loss_and_grads
    from repro_torch.training.optim import tree_leaves, tree_map

    kernels = (tree_attention, paged_tree_attention, ragged_paged_tree_attention, commit_kv, decode_attention,
               paged_decode_attention)
    cfg = get_smoke(arch).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    before = [k.launches for k in kernels]
    loss_c, grads_c = loss_and_grads(_to_cuda(params, cuda), cfg, _to_cuda(batch, cuda))
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    loss_h, grads_h = loss_and_grads(params, cfg, batch)
    assert abs(loss_c.item() - loss_h.item()) <= 1e-5 * abs(loss_h.item())
    for a, b in zip(tree_leaves(grads_c), tree_leaves(grads_h)):
        assert a.device.type == "cuda"
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    # without train=True the same pass on parameters that require grad is refused by the kernels
    live = tree_map(lambda t: t.requires_grad_(), _to_cuda(params, cuda))
    if cfg.arch_type != "ssm":
        with pytest.raises(RuntimeError, match="no backward"):
            forward(live, cfg, batch["tokens"].to(cuda))
