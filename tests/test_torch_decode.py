"""The port's decode-attention plain versions against the JAX package's
flash-decode kernels (Pallas, interpret mode), on the CPU.

``kernels.ops.gqa_decode_attention`` and ``gqa_paged_decode_attention``
(plain versions for CPU tensors) against ``repro.kernels.ops``'s wrappers of
the same names with ``interpret=True`` (block_k 128 for the dense one), on
the same numpy inputs: S 128 and 256, H 4 over Hkv 2, D 32, 48, 64, 128 and
256 (every head_dim the repo's models use), window 0 and 16, per-row lengths
from 1 to S, paged tables with unmapped (-1) blocks.
Tolerance: float32 1e-5 (summation order), bfloat16 2e-2 (output rounding).
A row of length 0 is held against the mean of V over all S slots (the JAX
dense wrapper averages it over its zero-padded S instead).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
H, HKV = 4, 2


def _inputs(rng, dtype, B, S, D, lengths):
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q = rng.standard_normal((B, 1, H, D)).astype(npdt)
    k = rng.standard_normal((B, S, HKV, D)).astype(npdt)
    v = rng.standard_normal((B, S, HKV, D)).astype(npdt)
    return q, k, v, np.asarray(lengths, np.int32)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("S,D", [(128, 64), (256, 128), (128, 32), (128, 48), (256, 256)])
def test_decode_attention_matches_jax(S, D, window, dtype):
    rng = np.random.default_rng(S + D + window)
    lengths = [1, 7, S // 2 + 3, S - 1, S]
    q, k, v, ln = _inputs(rng, dtype, len(lengths), S, D, lengths)
    got = tops.gqa_decode_attention(_t(q), _t(k), _t(v), _t(ln), window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    want = jops.gqa_decode_attention(*(jnp.asarray(a) for a in (q, k, v, ln)), block_k=128, window=window,
                                     interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("D", [64, 128, 32, 48, 256])
def test_paged_decode_attention_matches_jax(D, window, dtype):
    """Rows of 1..S logical slots over distinct arena blocks, the unmapped
    tail of each row at -1 (block 0 is trash), one row fully unmapped but
    for its first block."""
    rng = np.random.default_rng(D + window)
    B, nb, block = 4, 8, 16
    S = nb * block
    nblk = B * nb + 1
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    k = rng.standard_normal((nblk, block, HKV, D)).astype(npdt)
    v = rng.standard_normal((nblk, block, HKV, D)).astype(npdt)
    q = rng.standard_normal((B, 1, H, D)).astype(npdt)
    lengths = np.asarray([1, 37, 100, S], np.int32)
    tbl = (rng.permutation(nblk - 1)[: B * nb] + 1).reshape(B, nb).astype(np.int32)
    for b, n in enumerate(lengths):
        tbl[b, -(-n // block):] = -1  # blocks past the row's length are unmapped
    got = tops.gqa_paged_decode_attention(*(_t(a) for a in (q, k, v, tbl, lengths)), window=window)
    want = jops.gqa_paged_decode_attention(*(jnp.asarray(a) for a in (q, k, v, tbl, lengths)), window=window,
                                           interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("window", [0, 16])
def test_length_zero_rows_return_the_mean_of_v(window):
    """No valid slot: the mean of V over all S logical slots (the finite
    NEG_INF contract), dense and paged (unmapped blocks read the trash
    block 0), never NaN; the other rows are unaffected."""
    rng = np.random.default_rng(5)
    S, D = 64, 64
    q, k, v, ln = _inputs(rng, "float32", 2, S, D, [0, 20])
    got = tops.gqa_decode_attention(_t(q), _t(k), _t(v), _t(ln), window=window).numpy()
    mean_v = np.repeat(v[0].mean(axis=0), H // HKV, axis=0)  # (H, D): query head h reads KV head h // G
    np.testing.assert_allclose(got[0, 0], mean_v, atol=TOL["float32"], rtol=0)
    one = tops.gqa_decode_attention(_t(q[1:]), _t(k[1:]), _t(v[1:]), _t(ln[1:]), window=window).numpy()
    np.testing.assert_allclose(got[1:], one, atol=TOL["float32"], rtol=0)

    nb, block = 4, 16
    arena_k = rng.standard_normal((9, block, HKV, D)).astype(np.float32)
    arena_v = rng.standard_normal((9, block, HKV, D)).astype(np.float32)
    tbl = np.asarray([[3, -1, -1, -1], [5, 6, 7, 8]], np.int32)
    got = tops.gqa_paged_decode_attention(*(_t(a) for a in (q[:, :, :, :D], arena_k, arena_v, tbl, ln)),
                                          window=window).numpy()
    view = np.concatenate([arena_v[max(b, 0)] for b in tbl[0]])  # (S, Hkv, D), trash block for -1
    np.testing.assert_allclose(got[0, 0], np.repeat(view.mean(axis=0), H // HKV, axis=0),
                               atol=TOL["float32"], rtol=0)
    assert np.isfinite(got).all()
