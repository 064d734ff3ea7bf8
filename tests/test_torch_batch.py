"""The port's continuous-batching engine against the JAX package, on the CPU.

Same weights (bridged from JAX), same prompts and per-stream seeds, float32:

  * the port's ``BatchedSpeculativeEngine`` emits exactly the tokens, finish
    reasons and counters of the JAX ``BatchedSpeculativeEngine`` (paged
    pool, ragged auto-dispatch, XLA attention), synchronous and pipelined,
    with more requests than pool rows and mixed ``max_new``, and with
    arenas small enough to block admission, reclaim dead tails and evict;
    after every step both engines' pools hold the same tables, free lists
    and pos/len, and the same KV on every admitted lane;
  * each stream equals the port's own ``SpeculativeEngine`` with its seed;
  * ``ragged="always"`` equals ``ragged=False`` (and the ring pool).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np

from repro.models import cache as jc
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init_params
from repro.serving import batch_engine as jbe
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.models import cache as tc
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import batch_engine as tbe
from repro_torch.serving import engine as teng

V = 32
PROMPTS = [[5, 1, 7, 2], [9, 4], [3, 8, 8, 1, 6], [2, 2, 7], [11, 0, 4]]
SEEDS = [20, 21, 22, 23, 24]
MAX_NEW = [10, 6, 12, 4, 8]


# the JAX engines of this module share one jit cache: every compiled function
# is keyed by its config and shapes, so a case reuses what an earlier case
# compiled instead of recompiling it
JAX_JIT: dict = {}


def _pair(**kw):
    return JConfig(dtype="float32", **kw), TConfig(dtype="float32", **kw)


@pytest.fixture(scope="module")
def models():
    jt, tt = _pair(name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=96, vocab=V)
    jd, td = _pair(name="d", arch_type="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                   d_ff=96, vocab=V)
    jtp, jdp = j_init_params(jt, jax.random.PRNGKey(0)), j_init_params(jd, jax.random.PRNGKey(1))

    def to_t(p):
        return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)

    return (jt, jtp, jd, jdp), (tt, to_t(jtp), td, to_t(jdp))


def _run(eng, prompts=PROMPTS, max_new=MAX_NEW, seeds=SEEDS):
    rids = [eng.submit(list(p), max_new=m, seed=s) for p, m, s in zip(prompts, max_new, seeds)]
    outs = eng.run()
    return [(outs[r]["tokens"], outs[r]["reason"]) for r in rids]


def _counters(eng):
    return {k: v for k, v in eng.counters.items() if k != "commit_ms"}


def _same_pools(jeng, teng):
    """Both engines' target and draft pools: host tables and free lists bit
    for bit, pos/len exact, KV on every admitted lane (pos >= 0 in a row
    that holds a stream) to 1e-4.  Other lanes may differ: the port's trunk
    drafting writes at pos = -1, and free rows read the trash block."""
    for jp, tp in ((jeng.tpool, teng.tpool), (jeng.dpool, teng.dpool)):
        assert tp._free == jp._free
        if hasattr(jp, "_tbl"):
            np.testing.assert_array_equal(tp._tbl, jp._tbl)
            assert tp._free_blocks == jp._free_blocks
        rows = range(jp.n_slots)
        jv, tv = jc.gather_streams(jp.cache, rows)["attn"], tc.gather_streams(tp.cache, rows)["attn"]
        jpos = np.asarray(jv["pos"])
        np.testing.assert_array_equal(tv["pos"].numpy(), jpos)
        np.testing.assert_array_equal(tv["len"].numpy(), np.asarray(jv["len"]))
        live = (jpos >= 0) & np.isin(np.arange(jp.n_slots), sorted(jeng.streams))[:, None]
        for name in ("k", "v"):
            np.testing.assert_allclose(tv[name].numpy()[:, live], np.asarray(jv[name])[:, live], atol=1e-4, rtol=0)


def _both(models, verifier, prompts=PROMPTS, max_new=MAX_NEW, seeds=SEEDS, action=(2, 1, 2), **kw):
    """Step the JAX engine and the port's in lockstep on the same requests,
    holding their pools equal after every step; returns ((tokens, reasons),
    counters) of each, JAX first."""
    (jt, jtp, jd, jdp), (tt, ttp, td, tdp) = models
    engs = [mod.BatchedSpeculativeEngine(*args, emod.EngineConfig(verifier, *action, max_cache=64), **kw)
            for mod, emod, args in ((jbe, jeng, (jt, jtp, jd, jdp)), (tbe, teng, (tt, ttp, td, tdp)))]
    engs[0]._jit_cache = JAX_JIT
    rids = [[e.submit(list(p), max_new=m, seed=s) for p, m, s in zip(prompts, max_new, seeds)] for e in engs]
    while engs[0].queue or engs[0].streams:
        for e in engs:
            e.step()
        _same_pools(*engs)
    assert not (engs[1].queue or engs[1].streams)
    return [([(e.finished[r]["tokens"], e.finished[r]["reason"]) for r in rs], _counters(e))
            for e, rs in zip(engs, rids)]


@pytest.mark.parametrize("verifier,pipeline", [("specinfer", False), ("specinfer", True), ("traversal", True)])
def test_batched_engine_matches_jax(models, verifier, pipeline):
    (want, wc), (got, c) = _both(models, verifier, n_slots=3, paged=True, block_size=8, pipeline=pipeline,
                                 ragged=True)
    assert got == want
    assert {k: c[k] for k in wc} == wc
    assert c["accepted"] > 0 and c["ragged_calls"] > 0 and c["padded_calls"] > 0
    assert c["ragged_calls"] + c["padded_calls"] == c["target_calls"]
    if pipeline:
        assert c["pipeline_ahead"] > 0


def big_then_small(stream, engine):
    """A content-keyed selector: a big first tree, small ones after, so the
    first bucket maps tail blocks later frontiers do not cover."""
    return (2, 2, 2) if len(stream["committed"]) <= 4 else (1, 1, 1)


@pytest.mark.parametrize("case", ["reclaim", "evict"])
def test_block_pressure_matches_jax(models, case):
    """A queued long prompt whose admission waits on the free list and
    reclaims the dead tails of shrunken speculation buckets (pipelined);
    and LIFO eviction when reclamation cannot cover a step (synchronous)."""
    if case == "reclaim":
        (want, wc), (got, c) = _both(
            models, "specinfer", [[1, 2, 3], [7, 6, 5], list(range(1, 18))], [8, 8, 4], [40, 41, 42], (2, 1, 1),
            selector=big_then_small, n_slots=3, block_size=4, pool_blocks=7, pipeline=True)
        assert c["blocks_reclaimed"] > 0 and c["admit_blocked"] > 0
    else:
        (want, wc), (got, c) = _both(models, "specinfer", [[1, 2, 3], [4, 5, 6]], [24, 24], [50, 51],
                                     n_slots=2, block_size=4, pool_blocks=8, pipeline=False)
        assert c["evicted"] > 0 and got[1][1] == "evicted:pool_blocks"
    assert got == want
    assert {k: c[k] for k in wc} == wc


def test_batched_engine_matches_single_stream_engine(models):
    _, (tt, ttp, td, tdp) = models
    ecfg = dict(verifier="specinfer", K=2, L1=2, L2=1, max_cache=64)
    eng = tbe.BatchedSpeculativeEngine(tt, ttp, td, tdp, teng.EngineConfig(**ecfg), n_slots=2, block_size=16)
    got = [toks for toks, _ in _run(eng)]
    for toks, prompt, m, seed in zip(got, PROMPTS, MAX_NEW, SEEDS):
        single = teng.SpeculativeEngine(tt, ttp, td, tdp, teng.EngineConfig(**ecfg, seed=seed))
        assert toks == single.generate(list(prompt), max_new=m)


@pytest.mark.parametrize("pipeline", [False, True])
def test_ragged_always_matches_padded(models, pipeline):
    _, (tt, ttp, td, tdp) = models
    ecfg = teng.EngineConfig(verifier="traversal", K=2, L1=1, L2=1, max_cache=64)
    outs, counters = [], []
    for kw in (dict(ragged="always"), dict(ragged=False), dict(ragged=True, paged=False)):
        eng = tbe.BatchedSpeculativeEngine(tt, ttp, td, tdp, ecfg, n_slots=3, block_size=8,
                                           pipeline=pipeline, **kw)
        outs.append(_run(eng))
        counters.append(eng.counters)
    assert outs[0] == outs[1] == outs[2]
    assert counters[0]["padded_calls"] == 0 and counters[1]["ragged_calls"] == 0
    assert counters[2]["ragged_calls"] == 0  # a ring pool keeps the padded layout
    assert counters[0]["tree_lanes_total"] < counters[1]["tree_lanes_total"]


def test_submit_mid_run_rewinds_or_drains_exactly(models):
    """A request submitted while a step is begun ahead (a row free) rewinds
    or drains that step: the tokens equal the synchronous engine's."""
    _, (tt, ttp, td, tdp) = models
    ecfg = teng.EngineConfig(verifier="specinfer", K=2, L1=1, L2=1, max_cache=64)
    outs = []
    for pipeline in (True, False):
        eng = tbe.BatchedSpeculativeEngine(tt, ttp, td, tdp, ecfg, n_slots=3, block_size=8, pipeline=pipeline)
        rids = [eng.submit(PROMPTS[i], max_new=MAX_NEW[i], seed=SEEDS[i]) for i in range(2)]
        done = {}
        for _ in range(2):
            eng.step()
        rids.append(eng.submit(PROMPTS[2], max_new=MAX_NEW[2], seed=SEEDS[2]))
        done.update(eng.run())
        outs.append([done[r]["tokens"] for r in rids])
    assert outs[0] == outs[1]


def test_batched_engine_refuses_what_is_not_ported(models):
    _, (tt, ttp, td, tdp) = models
    with pytest.raises(NotImplementedError, match="queue 1 item 8c"):  # one pool over several devices
        tbe.BatchedSpeculativeEngine(tt, ttp, td, tdp, teng.EngineConfig(), mesh=["cpu", "cpu"])
    # refused as in JAX: the encdec/vlm prefill inputs are single-stream
    for arch_type in ("encdec", "vlm"):
        with pytest.raises(ValueError, match="batched serving covers decoder-only archs"):
            tbe.BatchedSpeculativeEngine(tt.replace(arch_type=arch_type), ttp, td, tdp, teng.EngineConfig())
    # refused as in JAX: batched serving verifies per stream on the host
    with pytest.raises(ValueError, match="verifies per-stream on host"):
        tbe.BatchedSpeculativeEngine(tt, ttp, td, tdp, teng.EngineConfig(verify_on_device=True))
