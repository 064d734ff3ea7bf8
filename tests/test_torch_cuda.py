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

# float32: summation order only; bfloat16: one rounding of the output
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}


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
    (3, 19, 8, 2, 1000, 64, 3),    # two query tiles, ragged key chunk, per-row mask
    (1, 16, 4, 4, 33, 128, 1),     # one full query tile, G = 1
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
