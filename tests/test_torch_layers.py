"""The PyTorch port's layers and warping against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and fed to both sides in float32;
every layer function must agree to atol 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import layers as jl
from repro.models.config import ModelConfig as JConfig
from repro.sampling import warp_logits as j_warp_logits
from repro_torch.models import layers as tl
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.sampling import warp_logits as t_warp_logits

ATOL = 1e-5


def _cfgs(**kw):
    return JConfig(dtype="float32", **kw), TConfig(dtype="float32", **kw)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = (0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 900, size=6).astype(np.int32)
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("mask_kind", ["none", "causal", "random4d"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1)])
def test_gqa_attend(mask_kind, H, Hkv):
    rng = np.random.default_rng(2)
    B, T, S, D = 2, 5, 5, 32
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    if mask_kind == "none":
        m = None
    elif mask_kind == "causal":
        m = np.array(jl.causal_mask(T))
        np.testing.assert_array_equal(tl.causal_mask(T).numpy(), m)
    else:
        m = rng.random((B, 1, T, S)) < 0.6
        m[0, 0, 1] = False  # a fully masked row
    out_t = tl.gqa_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                          None if m is None else torch.from_numpy(m))
    out_j = jl.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if m is None else jnp.asarray(m))
    _close(out_t, out_j)


@pytest.mark.parametrize("window", [0, 3])
def test_causal_mask(window):
    np.testing.assert_array_equal(tl.causal_mask(7, window).numpy(), np.asarray(jl.causal_mask(7, window)))


def test_swiglu():
    rng = np.random.default_rng(3)
    p = {n: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for n, s in [("w_gate", (48, 96)), ("w_up", (48, 96)), ("w_down", (96, 48))]}
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    _close(tl.swiglu({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x)),
           jl.swiglu({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_project_qkv(qkv_bias):
    jc, tc = _cfgs(d_model=64, n_heads=4, n_kv_heads=2, qkv_bias=qkv_bias)
    rng = np.random.default_rng(4)
    hd = jc.hd
    shapes = {"wq": (64, 4 * hd), "wk": (64, 2 * hd), "wv": (64, 2 * hd)}
    if qkv_bias:
        shapes.update({"bq": (4 * hd,), "bk": (2 * hd,), "bv": (2 * hd,)})
    p = {n: (0.1 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    out_t = tl.project_qkv({n: torch.from_numpy(a) for n, a in p.items()}, tc, torch.from_numpy(x))
    out_j = jl.project_qkv({n: jnp.asarray(a) for n, a in p.items()}, jc, jnp.asarray(x))
    for a, b in zip(out_t, out_j):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_init_helpers_match_shapes_and_scales(qkv_bias):
    """Same shapes, dtypes and distributions (the draws themselves differ)."""
    jc, tc = _cfgs(d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, qkv_bias=qkv_bias)
    gen = torch.Generator().manual_seed(0)
    pt = {**tl.attention_weights_init(tc, gen), **tl.swiglu_init(tc, gen)}
    key = jax.random.PRNGKey(0)
    pj = {**jl.attention_weights_init(jc, key), **jl.swiglu_init(jc, key)}
    assert sorted(pt) == sorted(pj)
    for name, a in pj.items():
        t = pt[name]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        if name.startswith("b"):
            assert not t.any()
        else:
            std = 1.0 / np.sqrt(a.shape[0])
            assert abs(t.std().item() - std) < 0.1 * std, name


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_warp_logits(temperature, top_p):
    rng = np.random.default_rng(5)
    logits = (2.0 * rng.standard_normal((3, 64))).astype(np.float32)
    out_t = t_warp_logits(torch.from_numpy(logits), temperature, top_p)
    out_j = j_warp_logits(jnp.asarray(logits), temperature, top_p)
    assert out_t.dtype == torch.float32
    _close(out_t, out_j)
    # the nucleus keeps the same support
    np.testing.assert_array_equal(out_t.numpy() > 0, np.asarray(out_j) > 0)
