"""The PyTorch port's dense ``forward`` against the JAX package, on the CPU.

Same weights (bridged from JAX), same tokens, float32.  Prefill (mode "full"
with a cache), decode and a delayed-tree pass run on both sides in turn, and
the logits, the hidden states and the whole cache (k, v, pos, len) must agree
to atol 1e-4 after every pass, under both JAX attention paths: "xla" and
"pallas" (the Pallas kernel in interpret mode).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import granite_3_2b, granite_8b, paper_llama70b_8b
from repro.core.trees import tree_ancestor_mask
from repro.models import transformer as jt
from repro_torch import bridge
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig

ATOL = 1e-4
SMAX = 32

CONFIGS = {
    "paper-llama70b": paper_llama70b_8b.smoke(),
    "paper-llama8b-draft": paper_llama70b_8b.smoke_draft(),
    "granite-8b": granite_8b.smoke(),
    "granite-3-2b": granite_3_2b.smoke(),  # tied embeddings
}


def to_torch_cfg(jcfg) -> TConfig:
    """The port's config with the same field values (the TPU switches drop)."""
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})


def _close(t, j, what):
    np.testing.assert_allclose(t, np.asarray(j), atol=ATOL, rtol=0, err_msg=what)


def _close_cache(tcache, jcache):
    tn = bridge.cache_to_numpy(tcache)["attn"]
    jn = jax.tree.map(np.asarray, jcache)["attn"]
    assert sorted(tn) == sorted(jn)
    for name in ("k", "v"):
        _close(tn[name], jn[name], f"cache {name}")
    np.testing.assert_array_equal(tn["pos"], jn["pos"])
    np.testing.assert_array_equal(tn["len"], jn["len"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_forward_matches_jax(arch, impl):
    jcfg = CONFIGS[arch].replace(dtype="float32", attention_impl=impl)
    tcfg = to_torch_cfg(jcfg)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    jfwd = jax.jit(jt.forward, static_argnames=("cfg", "mode"))

    def both(tokens, mode, jcache=None, tcache=None, anc=None):
        jl, jc, jex = jfwd(jp, jcfg, jnp.asarray(tokens), mode=mode, cache=jcache,
                           anc=None if anc is None else jnp.asarray(anc))
        tl, tc, tex = tt.forward(tp, tcfg, torch.from_numpy(tokens), mode=mode, cache=tcache,
                                 anc=None if anc is None else torch.from_numpy(anc))
        _close(tl.numpy(), jl, f"{mode} logits")
        _close(tex["hidden"].numpy(), jex["hidden"], f"{mode} hidden")
        if jc is not None:
            _close_cache(tc, jc)
        return jc, tc

    # mode "full" without a cache (training-style causal pass)
    both(rng.integers(0, jcfg.vocab, size=(2, 6)), "full")
    # prefill, then decode, then a (K, L1, L2) = (2, 1, 2) delayed-tree pass
    jc, tc = both(rng.integers(0, jcfg.vocab, size=(1, 5)), "full",
                  jt.init_cache(jcfg, 1, SMAX), tt.init_cache(tcfg, 1, SMAX, "cpu"))
    jc, tc = both(rng.integers(0, jcfg.vocab, size=(1, 2)), "decode", jc, tc)
    parent = np.array([-1, 0, 1, 2, 1, 4])
    anc = tree_ancestor_mask(parent)[None]
    both(rng.integers(0, jcfg.vocab, size=(1, len(parent))), "tree", jc, tc, anc)


def test_init_params_layout_matches_jax():
    """The port's own init draws the JAX package's tree: same nesting, shapes
    and dtypes (bf16 weights, fp32 norm scales), on the generator's device."""
    jcfg = granite_3_2b.smoke()
    tcfg = to_torch_cfg(jcfg)
    shapes_j = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0))))
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp)
    assert shapes_t == shapes_j
    assert "lm_head" not in tp  # tied embeddings
    assert abs(tp["embed"].float().std().item() - 0.02) < 0.002


def test_non_dense_arch_raises():
    tcfg = to_torch_cfg(granite_8b.smoke()).replace(arch_type="ssm")
    with pytest.raises(NotImplementedError, match="dense"):
        tt.init_cache(tcfg, 1, SMAX, "cpu")
