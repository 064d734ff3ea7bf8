"""The port's MoE family against the JAX package, on the CPU, in float32.

Same weights (bridged from JAX), same inputs made with numpy:

  * ``moe_apply`` (dropless routing, gates, combine and the aux loss, and
    training's capacity-factor dispatch) to atol 1e-5, at the qwen3-moe and
    llama4-maverick smoke sizes;
  * the bridge keeps the router float32 in a bf16 model, and the port's own
    ``init_params`` draws the JAX tree (flat and interleaved nesting);
  * ``forward`` logits, hidden state, aux and the whole cache to atol 1e-4 in
    modes full, decode and tree over a lockstep ring, then a padded
    per-stream decode (``lens``), per-row trees and the commit over a paged
    pool, and a ragged pass (real lanes only: padding lanes differ by
    design), for the flat qwen3-moe smoke and an interleaved
    llama4-maverick smoke of 2 groups (cache layer g*m + i);
  * decode logits equal the full pass's to 2e-4.

The engines on MoE models: tests/test_torch_moe_engine.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import llama4_maverick_400b_a17b as jllama4
from repro.configs import qwen3_moe_235b_a22b as jqwen3
from repro.models import cache as jc
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serving import serve_step as jss
from repro_torch import bridge
from repro_torch.models import cache as tc
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import serve_step as tss

ATOL_MOE = 1e-5  # one layer in float32: summation order only
ATOL = 1e-4      # a whole stack in float32
FLAT = jqwen3.smoke().replace(dtype="float32")
INTERLEAVED = jllama4.smoke().replace(dtype="float32", n_layers=4)  # 2 groups of (dense, moe)
CONFIGS = {"qwen3-moe flat": FLAT, "llama4-maverick interleaved": INTERLEAVED}


def to_torch_cfg(jcfg) -> TConfig:
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})


def _t(a):
    return torch.as_tensor(np.array(a))


def _to_t(p, dtype=torch.float32):
    return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=dtype)


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    jcfg = CONFIGS[request.param]
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, to_torch_cfg(jcfg), _to_t(jp)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_moe_apply_matches_jax(arch):
    jcfg = CONFIGS[arch]
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    tp = _to_t(jp)
    x = np.random.default_rng(4).standard_normal((3, 7, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, to_torch_cfg(jcfg), _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_MOE, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=ATOL_MOE, rtol=0)
    # training's capacity-factor dispatch (its drops: tests/test_torch_training.py)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), train=True)
    ty, taux = tmoe.moe_apply(tp, to_torch_cfg(jcfg), _t(x), train=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_MOE, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=ATOL_MOE, rtol=0)


def test_bridge_and_init_keep_the_router_float32():
    """A bf16 MoE model: the bridge rounds the experts to bf16 and keeps the
    router float32 (rounding it would change routing), and the port's own
    init draws the JAX package's tree, router float32 included."""
    import ml_dtypes

    for jcfg in (jqwen3.smoke(), jllama4.smoke()):
        assert jcfg.dtype == "bfloat16"
        shapes = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))
        as_np = jax.tree.map(lambda a: np.ones(a.shape, ml_dtypes.bfloat16 if a.dtype == jnp.bfloat16
                                               else a.dtype), shapes)
        tp = bridge.params_from_jax(as_np, device="cpu", dtype=torch.bfloat16)
        moe = tp["blocks"]["moe"] if jcfg.moe_every > 1 else tp["blocks"]
        assert moe["mlp"]["router"].dtype == torch.float32
        assert moe["mlp"]["w_gate"].dtype == torch.bfloat16
        assert moe["ln1"].dtype == torch.float32
        shapes_j = jax.tree.map(lambda a: (a.shape, str(a.dtype)), shapes)
        own = tt.init_params(to_torch_cfg(jcfg), torch.Generator().manual_seed(0))
        shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), own)
        assert shapes_t == shapes_j


def _close_cache(tcache, jcache):
    tn = bridge.cache_to_numpy(tcache)["attn"]
    jn = jax.tree.map(np.asarray, jcache)["attn"]
    assert sorted(tn) == sorted(jn)
    for name in ("k", "v"):
        np.testing.assert_allclose(tn[name], jn[name], atol=ATOL, rtol=0, err_msg=f"cache {name}")
    for name in ("pos", "len"):
        np.testing.assert_array_equal(tn[name], jn[name])


def test_forward_lockstep_matches_jax(model):
    """Full pass without a cache, prefill, decode and a delayed-tree pass."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(1)
    jfwd = jax.jit(jt.forward, static_argnames=("cfg", "mode"))

    def both(tokens, mode, jcache=None, tcache=None, anc=None):
        jl, jcache2, jex = jfwd(jp, jcfg, jnp.asarray(tokens), mode=mode, cache=jcache,
                                anc=None if anc is None else jnp.asarray(anc))
        tl, tcache2, tex = tt.forward(tp, tcfg, _t(tokens), mode=mode, cache=tcache,
                                      anc=None if anc is None else _t(anc))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0, err_msg=f"{mode} logits")
        np.testing.assert_allclose(tex["hidden"].numpy(), np.asarray(jex["hidden"]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tex["aux"].item(), float(jex["aux"]), atol=ATOL, rtol=0)
        if jcache2 is not None:
            _close_cache(tcache2, jcache2)
        return jcache2, tcache2

    both(rng.integers(0, jcfg.vocab, size=(2, 6)), "full")
    jcache, tcache = both(rng.integers(0, jcfg.vocab, size=(1, 5)), "full",
                          jt.init_cache(jcfg, 1, 32), tt.init_cache(tcfg, 1, 32, "cpu"))
    jcache, tcache = both(rng.integers(0, jcfg.vocab, size=(1, 2)), "decode", jcache, tcache)
    parent = np.array([-1, 0, 1, 2, 1, 4])
    anc = jss.device_ancestor_mask(jnp.asarray(parent[None]))
    both(rng.integers(0, jcfg.vocab, size=(1, len(parent))), "tree", jcache, tcache, np.asarray(anc))


def _run_both(jcfg, jp, tcfg, tp, jcache, tcache, toks, **kw):
    jl, jcache, _ = jt.forward(jp, jcfg, jnp.asarray(toks), cache=jcache,
                               **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else
                                  ({n: jnp.asarray(a) for n, a in v.items()} if isinstance(v, dict) else v)
                                  for k, v in kw.items()})
    tl, tcache, _ = tt.forward(tp, tcfg, _t(toks), cache=tcache,
                               **{k: _t(v) if isinstance(v, np.ndarray) else
                                  ({n: _t(a) for n, a in v.items()} if isinstance(v, dict) else v)
                                  for k, v in kw.items()})
    return (np.asarray(jl), jcache), (tl.numpy(), tcache)


def _check_pass(j, t, rows_or_nodes):
    """Logits of real rows or nodes; pos/len/tables exact; KV on admitted lanes."""
    (jl, jcache), (tl, tcache) = j, t
    np.testing.assert_allclose(tl[rows_or_nodes], jl[rows_or_nodes], atol=ATOL, rtol=0)
    jv, tv = jc.gather_streams(jcache, range(3)), tc.gather_streams(tcache, range(3))
    for name in ("pos", "len"):
        np.testing.assert_array_equal(tv["attn"][name].numpy(), np.asarray(jv["attn"][name]))
    np.testing.assert_array_equal(tcache["attn"]["block_tbl"].numpy(), np.asarray(jcache["attn"]["block_tbl"]))
    live = np.asarray(jv["attn"]["pos"]) >= 0
    for name in ("k", "v"):
        np.testing.assert_allclose(tv["attn"][name].numpy()[:, live], np.asarray(jv["attn"][name])[:, live],
                                   atol=ATOL, rtol=0)


def test_forward_per_stream_paged_and_ragged_match_jax(model):
    """Over a paged pool of 3 rows: a padded decode (lens), one row idle; a
    padded tree pass with per-row trees; the fused commit; then a ragged
    pass with a padding lane.  (The MoE layer does not see the pool's
    layout; the dense tests hold the ring pool.)"""
    jcfg, jp, tcfg, tp = model
    smax, blk = 32, 8
    jcache = jt.init_cache(jcfg, 3, smax, per_stream=True, page=(10, blk))
    tcache = tt.init_cache(tcfg, 3, smax, "cpu", per_stream=True, page=(10, blk))
    # rows 0 and 1 map blocks, row 2 stays idle (unmapped: trash)
    tbl = np.full((3, smax // blk), -1, np.int32)
    tbl[0, :2], tbl[1, :2] = [3, 1], [2, 5]
    jcache["attn"]["block_tbl"] = jnp.asarray(tbl)
    tcache["attn"]["block_tbl"] = _t(tbl)
    rng = np.random.default_rng(2)
    V = jcfg.vocab
    toks = rng.integers(0, V, size=(3, 4)).astype(np.int32)
    j, t = _run_both(jcfg, jp, tcfg, tp, jcache, tcache, toks, mode="decode", lens=np.asarray([4, 2, 0], np.int32))
    _check_pass(j, t, np.s_[[0], :4])
    _check_pass(j, t, np.s_[[1], :2])
    jcache, tcache = j[1], t[1]

    parents = np.asarray([[-1, 0, 1, 1, 2, -1, -1], [-1, 0, 0, 1, 2, 3, 4], [-1] * 7], np.int32)
    anc = np.asarray(jss.device_ancestor_mask(jnp.asarray(parents)))
    toks = rng.integers(0, V, size=(3, 7)).astype(np.int32)
    j, t = _run_both(jcfg, jp, tcfg, tp, jcache, tcache, toks, mode="tree", anc=anc)
    _check_pass(j, t, np.s_[:2])
    jcache = jc.merge_streams(j[1], jcache, jnp.asarray([True, True, False]))
    tcache = tc.merge_streams(t[1], tcache, _t(np.asarray([True, True, False])))

    npath = np.asarray([[1, 2, 0, 0], [1, 3, 5, 0], [0, 0, 0, 0]], np.int32)
    args = (npath, np.asarray([2, 3, 0], np.int32), np.asarray([3, 1, 0], np.int32), np.asarray([True, True, False]))
    jcache = jss.make_pool_commit_step(jcfg, 7)(jcache, *(jnp.asarray(a) for a in args))
    tcache = tss.make_pool_commit_step(7)(tcache, *(_t(a) for a in args))
    _check_pass((j[0], jcache), (t[0], tcache), np.s_[:2])
    ragged = {"owner": np.asarray([1, 1, 1, 0, 0, 0, 0, 0], np.int32),
              "parent": np.asarray([-1, 0, 0, -1, 3, 4, 4, -1], np.int32),
              "depth": np.asarray([0, 1, 1, 0, 1, 2, 2, 0], np.int32),
              "local": np.asarray([0, 1, 2, 0, 1, 2, 3, -1], np.int32),
              "counts": np.asarray([4, 3, 0], np.int32)}
    toks = rng.integers(0, V, size=(1, 8)).astype(np.int32)
    j, t = _run_both(jcfg, jp, tcfg, tp, jcache, tcache, toks, mode="tree", ragged=ragged)
    _check_pass(j, t, np.s_[:, :7])


def test_decode_matches_full_pass(model):
    """Dropless routing: a token's output does not depend on its co-tokens,
    so a decode step over the cache equals the full pass (as
    tests/test_models.py holds it for the JAX package)."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, tcfg.vocab, (2, 16)))
    lg, cache, _ = tt.forward(tp, tcfg, toks, mode="full", cache=tt.init_cache(tcfg, 2, 64, "cpu"))
    nxt = lg[:, -1:].argmax(-1)
    lg2, _, _ = tt.forward(tp, tcfg, nxt, mode="decode", cache=cache)
    lg_full, _, _ = tt.forward(tp, tcfg, torch.cat([toks, nxt], 1), mode="full")
    err = (lg2[:, -1] - lg_full[:, -1]).abs().max().item()
    assert err < 2e-4, err
