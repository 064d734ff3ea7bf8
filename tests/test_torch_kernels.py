"""The PyTorch port's ``tree_attention`` against the JAX package, on the CPU.

On the CPU ``kernels.ops.gqa_tree_attention`` takes the plain version; it is
held against the JAX wrapper running the Pallas kernel in interpret mode and
against the JAX oracle ``tree_attention_ref``, to atol 1e-5.  The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py; chip_smoke.py
holds it at the main path's shapes).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels.ref import tree_attention_ref as j_ref
from repro_torch.kernels.ops import gqa_tree_attention
from repro_torch.kernels.ref import tree_attention_ref
from repro_torch.kernels.tree_attention import tree_attention

ATOL = 1e-5


def _inputs(B, T, H, Hkv, S, D, Bm, seed, fully_masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    mask = rng.random((Bm, T, S)) < 0.5
    if fully_masked_row:
        mask[0, T - 1] = False
    return q, k, v, mask


def _fold_for_jax_ref(q, k, v, mask):
    """Engine layout -> the (BH, T, D) layout of the JAX oracle."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, T, D)
    kf = np.repeat(k.transpose(0, 2, 1, 3), H // Hkv, axis=1).reshape(B * H, S, D)
    vf = np.repeat(v.transpose(0, 2, 1, 3), H // Hkv, axis=1).reshape(B * H, S, D)
    mf = np.broadcast_to(np.broadcast_to(mask, (B, T, S))[:, None], (B, H, T, S)).reshape(B * H, T, S)
    return qf, kf, vf, mf


# S is a multiple of 128 so the JAX wrapper pads no key slots (a padded slot
# would enter the mean of V of a fully masked row there)
@pytest.mark.parametrize("B,T,H,Hkv,S,D,Bm,full_row", [
    (1, 7, 4, 4, 128, 64, 1, False),     # G = 1, broadcast mask
    (2, 5, 8, 2, 256, 64, 2, False),     # G = 4, per-row mask
    (2, 1, 8, 2, 128, 128, 1, False),    # G = 4, decode-shaped, broadcast mask
    (2, 3, 4, 1, 128, 32, 2, True),      # fully masked row
    (1, 9, 4, 1, 256, 64, 1, True),      # fully masked row, broadcast mask
])
def test_gqa_tree_attention_matches_jax(B, T, H, Hkv, S, D, Bm, full_row):
    q, k, v, mask = _inputs(B, T, H, Hkv, S, D, Bm, seed=B * 100 + T, fully_masked_row=full_row)
    out = gqa_tree_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    assert out.shape == (B, T, H, D) and np.isfinite(out).all()
    out_pallas = np.asarray(jops.gqa_tree_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(out, out_pallas, atol=ATOL, rtol=0)
    ref = np.asarray(j_ref(*(jnp.asarray(a) for a in _fold_for_jax_ref(q, k, v, mask))))
    ref = ref.reshape(B, H, T, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if full_row:  # the finite NEG_INF contract: the mean of V, never NaN
        G = H // Hkv
        mean_v = np.repeat(v[0].mean(axis=0), G, axis=0)  # (H, D)
        np.testing.assert_allclose(out[0, T - 1], mean_v, atol=ATOL, rtol=0)


def test_ref_keeps_bf16_dtype():
    q, k, v, mask = _inputs(1, 3, 4, 2, 16, 32, 1, seed=7)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)] + [torch.from_numpy(mask)]
    out = tree_attention_ref(*args)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), tree_attention_ref(
        *(a.float() for a in args[:3]), args[3]).numpy(), atol=2e-2, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: a CPU tensor never reaches a silent
    substitute there (kernels.ops does the dispatch by device)."""
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(1, 2, 4, 2, 16, 64, 1, seed=8))
    before = tree_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        tree_attention(q, k, v, mask)
    assert tree_attention.launches == before
