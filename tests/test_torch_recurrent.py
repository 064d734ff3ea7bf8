"""The port's recurrent families against the JAX package, on the CPU.

Same weights (bridged from JAX), same inputs made from a seed with numpy,
float32:

  * the layers: ``ssd_chunked``, ``ssm_apply`` in its three branches (no
    cache, one step from a state, several steps from a state),
    ``_lru_scan`` (with and without h0, past one scan chunk) and
    ``rglru_apply``, within 1e-5;
  * ``forward`` on the mamba2-2.7b and recurrentgemma-2b smokes: "full"
    without a cache, prefill, "decode" of 1 and of 3 tokens from the state,
    logits, hidden states and every cache leaf within 1e-4 (pos/len exact);
  * the stream helpers (gather, fork, scatter, concat, merge) on ssm and
    hybrid caches, ring and paged, bit for bit against JAX;
  * the bridge and ``init_params`` keep the float32 leaves float32 in a
    bf16 model, with the JAX package's tree;
  * ``CachePool`` frames: ``rollback_frame`` restores the pool bit for bit;
  * the CLI serves both arches, and its tokens equal the JAX launcher's
    (float32 smokes, the JAX weights).
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import mamba2_2_7b, recurrentgemma_2b
from repro.launch import serve as jserve
from repro.models import cache as jc
from repro.models import rglru as jr
from repro.models import ssm as js
from repro.models import transformer as jt
from repro_torch import bridge
from repro_torch.launch import serve as tserve
from repro_torch.models import cache as tc
from repro_torch.models import rglru as tr
from repro_torch.models import ssm as ts
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig

LAYER_ATOL = 1e-5
FORWARD_ATOL = 1e-4
SMAX = 32
SMOKES = {"mamba2-2.7b": mamba2_2_7b.smoke(), "recurrentgemma-2b": recurrentgemma_2b.smoke()}


def to_torch_cfg(jcfg) -> TConfig:
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bridge(jp):
    return bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)


def _close(t, j, what, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0, err_msg=what)


# ------------------------------------------------------------------ layers ---

SSM_KW = dict(arch_type="ssm", n_layers=1, d_model=64, vocab=32, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
              ssm_groups=2, dtype="float32")
HYB_KW = dict(arch_type="hybrid", n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=96, vocab=32,
              lru_width=64, local_window=16, dtype="float32")


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(0)
    b, S, H, P, G, N = 2, 24, 4, 8, 2, 16
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dtA = -rng.uniform(0.01, 0.5, (b, S, H)).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    jy, js_ = jax.jit(js.ssd_chunked, static_argnums=4)(jnp.asarray(x), jnp.asarray(dtA), jnp.asarray(B),
                                                       jnp.asarray(C), 8)
    ty, ts_ = ts.ssd_chunked(_t(x), _t(dtA), _t(B), _t(C), 8)
    _close(ty, jy, "y", LAYER_ATOL)
    _close(ts_, js_, "state", LAYER_ATOL)


@pytest.mark.parametrize("S,with_cache", [(11, False), (1, True), (3, True), (9, True)],
                         ids=["no-cache", "one-step", "chunked-from-state", "two-chunks-from-state"])
def test_ssm_apply_matches_jax(S, with_cache):
    jcfg = mamba2_2_7b.CONFIG.replace(**SSM_KW)
    tcfg = to_torch_cfg(jcfg)
    jp = js.init_ssm(jcfg, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jcache = tcache = None
    if with_cache:
        conv_dim = jcfg.d_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state
        st = 0.3 * rng.standard_normal((2, jcfg.ssm_heads, jcfg.ssm_headdim, jcfg.ssm_state)).astype(np.float32)
        cv = rng.standard_normal((2, jcfg.ssm_conv - 1, conv_dim)).astype(np.float32)
        jcache, tcache = {"state": jnp.asarray(st), "conv": jnp.asarray(cv)}, {"state": _t(st), "conv": _t(cv)}
    jy, jn = jax.jit(js.ssm_apply, static_argnums=1)(jp, jcfg, jnp.asarray(u), jcache)
    ty, tn = ts.ssm_apply(tp, tcfg, _t(u), tcache)
    _close(ty, jy, "y", LAYER_ATOL)
    for k in ("state", "conv"):
        _close(tn[k], jn[k], k, LAYER_ATOL)


@pytest.mark.parametrize("S,with_h0", [(5, False), (130, True)], ids=["short", "three-chunks-from-h0"])
def test_lru_scan_matches_jax(S, with_h0):
    rng = np.random.default_rng(2)
    log_a = -rng.uniform(0.001, 0.2, (2, S, 16)).astype(np.float32)
    b = rng.standard_normal((2, S, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if with_h0 else None
    jh = jax.jit(jr._lru_scan)(jnp.asarray(log_a), jnp.asarray(b), None if h0 is None else jnp.asarray(h0))
    th = tr._lru_scan(_t(log_a), _t(b), None if h0 is None else _t(h0))
    _close(th, jh, "h", LAYER_ATOL)


def test_lru_scan_stays_finite_on_long_decays():
    """The closed form exponentiates differences of the cumulative log
    decay only: 4096 steps of log a = -20 would overflow exp(-A_s)."""
    log_a = torch.full((1, 4096, 4), -20.0)
    b = torch.ones((1, 4096, 4))
    h = tr._lru_scan(log_a, b, torch.ones((1, 4)))
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h[:, -1], torch.ones((1, 4)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("S,with_cache", [(70, False), (1, True), (3, True)],
                         ids=["no-cache", "one-step", "three-from-state"])
def test_rglru_apply_matches_jax(S, with_cache):
    jcfg = recurrentgemma_2b.CONFIG.replace(**HYB_KW)
    tcfg = to_torch_cfg(jcfg)
    jp = jr.init_rglru(jcfg, jax.random.PRNGKey(1))
    tp = _bridge(jp)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jcache = tcache = None
    if with_cache:
        st = rng.standard_normal((2, jcfg.lru_d)).astype(np.float32)
        cv = rng.standard_normal((2, 3, jcfg.lru_d)).astype(np.float32)
        jcache, tcache = {"state": jnp.asarray(st), "conv": jnp.asarray(cv)}, {"state": _t(st), "conv": _t(cv)}
    jy, jn = jax.jit(jr.rglru_apply, static_argnums=1)(jp, jcfg, jnp.asarray(u), jcache)
    ty, tn = tr.rglru_apply(tp, tcfg, _t(u), tcache)
    _close(ty, jy, "y", LAYER_ATOL)
    for k in ("state", "conv"):
        _close(tn[k], jn[k], k, LAYER_ATOL)


# ----------------------------------------------------------------- forward ---

def _close_caches(tcache, jcache):
    tn = bridge.cache_to_numpy(tcache)
    jn = jax.tree.map(np.asarray, jcache)
    assert sorted(tn) == sorted(jn)
    for key in jn:
        if key == "attn":
            for name in ("pos", "len"):
                np.testing.assert_array_equal(tn[key][name], jn[key][name])
            for name in ("k", "v"):
                _close(tn[key][name], jn[key][name], f"attn {name}", FORWARD_ATOL)
        elif key == "len":
            np.testing.assert_array_equal(tn[key], jn[key])
        else:
            _close(tn[key], jn[key], key, FORWARD_ATOL)


@pytest.mark.parametrize("arch", list(SMOKES))
def test_forward_matches_jax(arch):
    jcfg = SMOKES[arch].replace(dtype="float32")
    tcfg = to_torch_cfg(jcfg)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    rng = np.random.default_rng(4)
    jfwd = jax.jit(jt.forward, static_argnames=("cfg", "mode"))

    def both(tokens, mode, jcache=None, tcache=None):
        jl, jcache, jex = jfwd(jp, jcfg, jnp.asarray(tokens), mode=mode, cache=jcache)
        tl, tcache, tex = tt.forward(tp, tcfg, _t(tokens), mode=mode, cache=tcache)
        _close(tl, jl, f"{mode} logits", FORWARD_ATOL)
        _close(tex["hidden"], jex["hidden"], f"{mode} hidden", FORWARD_ATOL)
        if jcache is not None:
            _close_caches(tcache, jcache)
        return jcache, tcache

    both(rng.integers(0, jcfg.vocab, size=(2, 20)), "full")
    jcache, tcache = both(rng.integers(0, jcfg.vocab, size=(2, 6)), "full",
                          jt.init_cache(jcfg, 2, SMAX), tt.init_cache(tcfg, 2, SMAX, "cpu"))
    for T in (1, 3):
        jcache, tcache = both(rng.integers(0, jcfg.vocab, size=(2, T)), "decode", jcache, tcache)


def test_init_params_and_bridge_keep_fp32_leaves():
    """A bf16 model: the port's own init draws the JAX package's tree and
    dtypes, and the bridge rounds the projections to bf16 but keeps the
    norms, the SSM's A_log/D/dt_bias/norm_z and the RG-LRU's gates and
    lam float32, as JAX does."""
    for arch, jcfg in SMOKES.items():
        shapes_j = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0))))
        tp = tt.init_params(to_torch_cfg(jcfg), torch.Generator().manual_seed(0))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp) == shapes_j
        jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
        bp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.bfloat16)
        assert jax.tree.map(lambda t: str(t.dtype).replace("torch.", ""), bp) == \
            jax.tree.map(lambda a: str(a.dtype), jp)
        if arch == "mamba2-2.7b":
            ssm = bp["blocks"]["ssm"]
            assert all(ssm[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias", "norm_z"))
            assert ssm["w_in"].dtype == torch.bfloat16
        else:
            rec = bp["blocks"]["rec0"]["rec"]
            assert all(rec[k].dtype == torch.float32 for k in ("w_a", "b_a", "w_i", "b_i", "lam"))
            assert rec["w_x"].dtype == torch.bfloat16


# ----------------------------------------------------------- stream helpers ---

def _cache_pair(jcfg, rng, paged):
    """The same random per-stream cache (3 rows) in JAX and in the port."""
    page = (12, 8) if paged else None
    jcache = jt.init_cache(jcfg, 3, SMAX, per_stream=True, page=page)
    leaves = jax.tree.map(np.asarray, jcache)

    def fill(key, a):
        if key == "block_tbl":
            return np.asarray([[1, 2, -1, -1], [3, -1, -1, -1], [-1] * 4], np.int32)
        if a.dtype.kind == "i":
            return rng.integers(-1, SMAX, size=a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)

    filled = {k: ({n: fill(n, a) for n, a in v.items()} if isinstance(v, dict) else fill(k, v))
              for k, v in leaves.items()}
    return jax.tree.map(jnp.asarray, filled), {k: ({n: _t(a) for n, a in v.items()} if isinstance(v, dict)
                                                 else _t(v)) for k, v in filled.items()}


def _same(tcache, jcache):
    tn = bridge.cache_to_numpy(tcache)
    jn = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(tn) == jax.tree.structure(jn)
    for a, b in zip(jax.tree.leaves(tn), jax.tree.leaves(jn)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("arch", list(SMOKES))
def test_stream_helpers_match_jax_bit_for_bit(arch, paged):
    jcfg = SMOKES[arch].replace(dtype="float32")
    rng = np.random.default_rng(5)
    jpool, tpool = _cache_pair(jcfg, rng, paged)
    # the JAX helpers jitted: one compile each instead of one per eager op
    j_gather, j_concat, j_merge, j_scatter = (jax.jit(f) for f in (
        jc.gather_streams, jc.concat_streams, jc.merge_streams, jc.scatter_streams))
    _same(tc.gather_streams(tpool, [2, 0]), j_gather(jpool, jnp.asarray([2, 0])))
    _same(tc.fork_streams(tpool, 2), jax.jit(jc.fork_streams, static_argnums=1)(jpool, 2))
    jrows = j_gather(jpool, jnp.asarray([1, 0]))
    trows = tc.gather_streams(tpool, [1, 0])
    _same(tc.concat_streams([trows, tc.gather_streams(tpool, [2])]),
          j_concat([jrows, j_gather(jpool, jnp.asarray([2]))]))
    # merge: two distinct caches, a per-row select
    jother, tother = _cache_pair(jcfg, np.random.default_rng(6), paged)
    keep = np.asarray([True, False, True])
    _same(tc.merge_streams(tother, tpool, keep), j_merge(jother, jpool, jnp.asarray(keep)))
    # last: the port's scatter writes the pool's k/v in place
    jnew, tnew = j_scatter(jpool, jrows, jnp.asarray([0, 1])), tc.scatter_streams(tpool, trows, [0, 1])
    if paged:  # scatters of unmapped blocks all land in the trash block: compare the mapped rows
        _same(tc.gather_streams(tnew, [0, 1]), j_gather(jnew, jnp.asarray([0, 1])))
    else:
        _same(tnew, jnew)


def test_scatter_never_writes_recurrent_leaves_in_place():
    jcfg = SMOKES["recurrentgemma-2b"].replace(dtype="float32")
    _, tpool = _cache_pair(jcfg, np.random.default_rng(7), False)
    before = {k: v.clone() for k, v in tpool.items() if k != "attn"}
    tc.scatter_streams(tpool, tc.gather_streams(tpool, [2]), [0])
    for k, v in before.items():
        assert torch.equal(tpool[k], v), k


@pytest.mark.parametrize("arch", list(SMOKES))
def test_rollback_frame_restores_the_pool(arch):
    """A frame held across writes the ingest makes (a scatter writes the
    attention k/v in place) rolls back to the cache as it was, bit for bit."""
    jcfg = SMOKES[arch].replace(dtype="float32")
    _, cache = _cache_pair(jcfg, np.random.default_rng(8), True)
    pool = tc.make_cache_pool(cache, 3)
    want = jax.tree.map(np.copy, bridge.cache_to_numpy(pool.cache))  # CPU numpy views alias the tensors
    pool.begin_frame()
    assert pool.frame_held
    pool.cache = tc.scatter_streams(pool.cache, tc.gather_streams(pool.cache, [1, 0]), [0, 1])
    assert jax.tree.leaves(jax.tree.map(lambda a, b: not np.array_equal(a, b), bridge.cache_to_numpy(pool.cache),
                                        want))  # something changed
    pool.rollback_frame()
    assert not pool.frame_held
    got = bridge.cache_to_numpy(pool.cache)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="no frame"):
        pool.rollback_frame()


# --------------------------------------------------------------------- CLI ---

def test_cli_serves_recurrent_arches_and_matches_jax(capsys, monkeypatch):
    """``--smoke --arch mamba2-2.7b`` serves through the port's launcher, and
    with float32 smokes and the JAX weights (the port draws its own from
    torch generators, so the test hands it the JAX package's) it prints the
    JAX launcher's tokens for one request of 8 tokens."""
    monkeypatch.setattr(jserve, "get_smoke", lambda name: SMOKES[name].replace(dtype="float32"))
    monkeypatch.setattr(tserve, "get_smoke", lambda name: to_torch_cfg(SMOKES[name].replace(dtype="float32")))

    def jax_weights(cfg, gen):
        jcfg = jserve.get_smoke("mamba2-2.7b")
        jcfg = jcfg if cfg.name == jcfg.name else jserve.make_draft_cfg(jcfg)
        return _bridge(jt.init_params(jcfg, jax.random.PRNGKey(gen.initial_seed())))

    monkeypatch.setattr(tserve, "init_params", jax_weights)
    args = ["--arch", "mamba2-2.7b", "--smoke", "--requests", "1", "--max-new", "8", "--L1", "1", "--L2", "1"]
    jserve.main(args)
    want = re.findall(r"req0: \[.*\]", capsys.readouterr().out)
    tserve.main(args + ["--device", "cpu"])
    got = re.findall(r"req0: \[.*\]", capsys.readouterr().out)
    assert got == want and len(want) == 1
    monkeypatch.undo()
    tserve.main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu", "--streams", "2", "--requests", "3",
                 "--max-new", "6"])
    out = capsys.readouterr().out
    assert all(f"req{r}: [" in out for r in range(3)) and "[batched x2]" in out and "paged(block=64" in out
