"""The port's selectors in both engines against the JAX package, on the CPU.

Same model and selector weights (bridged from JAX), same prompts and seeds,
float32:

  * ``NeuralSelector``: the port's ``SpeculativeEngine`` takes the JAX
    engine's actions, step by step, and emits its tokens; the port's
    ``BatchedSpeculativeEngine`` takes each stream's actions of the port's
    single-stream engine and the JAX batched engine's, with their tokens;
  * ``AnalyticSelector``: the same tokens as JAX, single-stream and batched;
  * the batched engine's pooled peeks score what the single-stream peeks
    score (1e-5) and leave both pools as they were, bit for bit;
  * ``AnalyticSelector`` raises on an engine without peeks.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np

from repro.core import delayed as jdelayed
from repro.core import selector as jsel
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init_params
from repro.serving import batch_engine as jbe
from repro.serving import engine as jeng
from repro.serving import nde as jnde
from repro_torch import bridge
from repro_torch.core import delayed as tdelayed
from repro_torch.core import selector as tsel
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import batch_engine as tbe
from repro_torch.serving import engine as teng
from repro_torch.serving import nde as tnde

V = 32
ACTIONS = [(1, 3, 0), (2, 1, 1), (2, 2, 2), (4, 1, 1)]
LAT = (1e-4, 1e-8, 1.2e-3, 1e-7)
PROMPTS = [[5, 1, 7, 2], [9, 4], [3, 8, 8, 1, 6]]
SEEDS = [30, 31, 32]
MAX_NEW = [12, 8, 10]


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


class Recording:
    """Wraps a selector and records (stream id, action) per call, and the
    actions by the engine's block count at the call (every call of one
    batched step sees the same count, and the next step a larger one)."""

    def __init__(self, selector, key):
        self.selector, self.key, self.calls, self.by_step = selector, key, [], {}

    def __call__(self, stream, engine):
        a = tuple(self.selector(stream, engine))
        self.calls.append((self.key(stream), a))
        self.by_step.setdefault(engine.counters["blocks"], set()).add(a)
        return a


@pytest.fixture(scope="module")
def neural():
    """A NeuralSelector's params and config for the models' widths, in both
    packages; the init is scaled so that the actions it takes vary."""
    jcfg = jsel.SelectorConfig(hidden_p=64, hidden_q=32, space=jsel.FixedSpace(ACTIONS))
    tcfg = tsel.SelectorConfig(hidden_p=64, hidden_q=32, space=tsel.FixedSpace(ACTIONS))
    jp = jsel.init_selector(jcfg, jax.random.PRNGKey(3))
    jp["out"]["w"] = jp["out"]["w"] * 8.0
    tp = bridge.selector_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    sampling = (0.9, 1.0)

    def make(pkg):
        if pkg == "jax":
            return jnde.NeuralSelector(jp, jcfg, jdelayed.LatencyModel(*LAT), jeng.SamplingParams(*sampling))
        return tnde.NeuralSelector(tp, tcfg, tdelayed.LatencyModel(*LAT), teng.SamplingParams(*sampling))

    return make, sampling


# one jit cache for this module's JAX single-stream engines and one for its
# batched ones: every compiled function is keyed by its config and shapes, so
# an engine reuses what an earlier one compiled instead of recompiling it
JAX_JIT = {"single": {}, "batched": {}}


def _single(mod, args, selector, sampling, seed, prompt, max_new):
    eng = mod.SpeculativeEngine(*args, mod.EngineConfig("specinfer", max_cache=64, seed=seed),
                                mod.SamplingParams(*sampling), selector=selector)
    if mod is jeng:
        eng._jit_cache = JAX_JIT["single"]
    return eng.generate(list(prompt), max_new=max_new), eng


def test_neural_selector_single_stream_matches_jax(models, neural):
    make, sampling = neural
    (jargs, targs) = models
    out = []
    for pkg, mod, args in (("jax", jeng, jargs), ("torch", teng, targs)):
        rec = Recording(make(pkg), key=lambda st: 0)
        toks = [_single(mod, args, rec, sampling, s, p, m)[0] for p, s, m in zip(PROMPTS[:2], SEEDS, MAX_NEW)]
        out.append((toks, rec.calls))
    assert out[1] == out[0]
    assert len({a for _, a in out[0][1]}) > 1  # the selector's choice varies along the streams


def _batched(mod, emod, args, selector, sampling, pipeline, **kw):
    eng = mod.BatchedSpeculativeEngine(*args, emod.EngineConfig("specinfer", max_cache=64),
                                       emod.SamplingParams(*sampling), selector=selector, n_slots=2,
                                       block_size=8, pipeline=pipeline, **kw)
    if mod is jbe:
        eng._jit_cache = JAX_JIT["batched"]
    rids = [eng.submit(list(p), max_new=m, seed=s) for p, m, s in zip(PROMPTS, MAX_NEW, SEEDS)]
    out = eng.run()
    return [out[r]["tokens"] for r in rids], eng


def _by_stream(calls):
    out = {}
    for rid, a in calls:
        out.setdefault(rid, []).append(a)
    return out


@pytest.fixture(scope="module")
def jax_batched_neural(models, neural):
    """The JAX batched engine's tokens and per-stream actions under the
    NeuralSelector (synchronous: its pipelined stepping gives the same)."""
    make, sampling = neural
    jrec = Recording(make("jax"), key=lambda st: st["rid"])
    want, _ = _batched(jbe, jeng, models[0], jrec, sampling, False)
    return want, _by_stream(jrec.calls)


@pytest.mark.parametrize("pipeline", [False, True])
def test_neural_selector_batched_matches_single_and_jax(models, neural, jax_batched_neural, pipeline):
    make, sampling = neural
    targs = models[1]
    max_new = MAX_NEW
    trec = Recording(make("torch"), key=lambda st: st["rid"])
    got, _ = _batched(tbe, teng, targs, trec, sampling, pipeline)
    want, want_actions = jax_batched_neural
    assert got == want
    assert _by_stream(trec.calls) == want_actions
    # each stream takes the actions and tokens of the port's own single-stream engine
    for rid, (p, s, m) in enumerate(zip(PROMPTS, SEEDS, max_new)):
        srec = Recording(make("torch"), key=lambda st: rid)
        toks, _ = _single(teng, targs, srec, sampling, s, p, m)
        assert toks == got[rid]
        assert [a for _, a in srec.calls] == _by_stream(trec.calls)[rid]
    # some step served mixed actions
    assert any(len(acts) > 1 for acts in trec.by_step.values())


def _analytic(pkg, seed=0):
    dmod, nmod = (jdelayed, jnde) if pkg == "jax" else (tdelayed, tnde)
    return nmod.AnalyticSelector([(1, 1, 0), (2, 1, 1)], dmod.LatencyModel(*LAT), "specinfer", s=1, seed=seed)


def test_analytic_selector_single_stream_matches_jax(models):
    jargs, targs = models
    out = []
    for pkg, mod, args in (("jax", jeng, jargs), ("torch", teng, targs)):
        rec = Recording(_analytic(pkg), key=lambda st: 0)
        toks, eng = _single(mod, args, rec, (1.0, 1.0), 5, PROMPTS[0], 8)
        out.append((toks, rec.calls, dict(eng.counters)))
    assert out[1] == out[0]


def test_analytic_selector_batched_matches_jax(models):
    jargs, targs = models
    out = []
    for pkg, mod, emod, args in (("jax", jbe, jeng, jargs), ("torch", tbe, teng, targs)):
        rec = Recording(_analytic(pkg), key=lambda st: st["rid"])
        eng = mod.BatchedSpeculativeEngine(*args, emod.EngineConfig("specinfer", max_cache=64), selector=rec,
                                           n_slots=2, block_size=8)
        if mod is jbe:
            eng._jit_cache = JAX_JIT["batched"]
        out.append((eng.generate_batch([[1, 2, 3], [4, 5]], max_new=6, seeds=[1, 2]), rec.calls))
    assert out[1] == out[0]
    assert all(len(t) == 6 for t in out[1][0])


def _pool_state(eng):
    return [t.clone() for pool in (eng.tpool, eng.dpool) for t in pool.cache["attn"].values()]


@pytest.mark.parametrize("paged", [True, False])
def test_pooled_peeks_match_single_engine(models, paged):
    """The pooled peek oracles (a gathered row, decoded on a copy) score the
    same distributions as the single-stream engine's peeks, and leave the
    pools bit for bit as they were."""
    _, (tt, ttp, td, tdp) = models
    ecfg = teng.EngineConfig(verifier="specinfer", K=2, L1=1, L2=1, max_cache=64, seed=5)
    single = teng.SpeculativeEngine(tt, ttp, td, tdp, ecfg)
    stream = single.new_stream([1, 2, 3])
    engs = [tbe.BatchedSpeculativeEngine(tt, ttp, td, tdp, ecfg, n_slots=2, paged=paged, block_size=8,
                                         pipeline=False)
            for _ in range(2)]
    for e in engs:
        e.submit([9, 9, 4, 4, 2], max_new=8, seed=6)  # a neighbour row the peeks must not touch
        e.submit([1, 2, 3], max_new=8, seed=5)
        e.step()
    beng, untouched = engs
    # both advanced one block with identical rng state: peek at the boundary
    # (synchronous stepping: no step is begun ahead, as when a selector runs)
    single.step(stream)
    bstream = next(st for st in beng.streams.values() if st["rid"] == 1)
    assert bstream["committed"] == stream["committed"]
    before = _pool_state(beng)
    for ctx in ([], [7], [7, 11]):
        np.testing.assert_allclose(beng.peek_target_dist(bstream, ctx), single.peek_target_dist(stream, ctx),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(beng.peek_draft_dist(bstream, ctx), single.peek_draft_dist(stream, ctx),
                                   rtol=0, atol=1e-5)
    after = _pool_state(beng)
    assert len(before) == len(after) and all(torch.equal(a, b) for a, b in zip(before, after))
    assert bstream["committed"] == stream["committed"]
    # the peeks changed nothing the engine goes on with: it ends as the engine that never peeked
    assert beng.run() == untouched.run()


def test_analytic_selector_fails_loud_without_peeks(models):
    class NoPeeks:
        pass

    with pytest.raises(TypeError, match="needs peek_draft_dist/peek_target_dist oracles, which NoPeeks"):
        _analytic("torch")({"committed": [1, 2]}, NoPeeks())


def test_static_selector():
    assert tnde.StaticSelector(2, 1, 3)({}, None) == (2, 1, 3)
