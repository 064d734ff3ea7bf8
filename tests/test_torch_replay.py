"""The port's engines on the replay strategy against the JAX package, on the CPU.

The small SSM and hybrid configs of tests/test_batch_engine.py in float32,
the target drawn from one key and the draft (the same config) from another,
both bridged from JAX.  (With the draft equal to the target every ratio
p/q that greedy_mpbv orders by is 1 up to rounding, so its choices follow
the rounding of each engine's batch: ROADMAP queue 3.)

  * ``BatchedSpeculativeEngine``, stepped in lockstep with the JAX engine
    over more requests than pool rows, on the ring and the paged arena,
    synchronous and pipelined: tokens, finish reasons and counters equal,
    and after every step both engines' pools hold the same free lists and
    block tables, the same pos/len, and the same recurrent state and KV on
    every row that holds a stream (within 1e-4, the forward tolerance: the
    two frameworks' float32 matmuls round differently; running this file
    as a script prints the largest difference of each leaf);
  * the replay trunk leaves the target pool as it was until the commit,
    and ``abort_step`` of a begun step rolls the recurrent draft pool back
    bit for bit; a request submitted mid-run rewinds the begun step and
    the tokens equal the synchronous engine's.

The single-stream engine's counterpart is tests/test_torch_replay_single.py.
The JAX engines of one family share one jit cache (their compiled passes
depend on the config and the shapes only), so each shape compiles once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax

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
KW = {
    "ssm": dict(name="s", arch_type="ssm", n_layers=2, d_model=48, vocab=V, ssm_state=16, ssm_headdim=16,
                ssm_chunk=8, dtype="float32"),
    "hybrid": dict(name="h", arch_type="hybrid", n_layers=5, d_model=48, n_heads=4, n_kv_heads=1, d_ff=96,
                   vocab=V, local_window=32, dtype="float32"),
}
ATOL = 1e-4  # the forward tolerance: KV and state after several steps of float32 rounding apart
PROMPTS = [[5, 1, 7, 2], [9, 4, 6, 3], [3, 8], [2, 2]]
SEEDS = [20, 21, 22, 23]
MAX_NEW = [8, 5, 6, 4]
ACTION = (2, 1, 1)


@pytest.fixture(scope="module", params=list(KW))
def family(request):
    kw = KW[request.param]
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    init = jax.jit(j_init_params, static_argnums=0)
    jtp, jdp = init(jcfg, jax.random.PRNGKey(0)), init(jcfg, jax.random.PRNGKey(1))

    def to_t(p):
        return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)

    return {"name": request.param, "jax": (jcfg, jtp, jcfg, jdp), "torch": (tcfg, to_t(jtp), tcfg, to_t(jdp)),
            "jit": {}}


def _counters(eng):
    return {k: v for k, v in eng.counters.items() if k != "commit_ms"}


# ------------------------------------------------------------------ batched ---

def _rows(key, val):
    """A pool leaf with its stream axis first."""
    if key in ("rec_state", "rec_conv"):
        return np.moveaxis(val, 2, 0)
    if key in ("state", "conv", "tail_state", "tail_conv"):
        return np.moveaxis(val, 1, 0)
    return val


def _close(worst, key, got, want):
    """assert_allclose at ATOL, noting the largest difference by leaf."""
    if got.size:
        worst[key] = max(worst.get(key, 0.0), float(np.abs(got.astype(np.float64) - want).max()))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=key)


def _same_pools(jeng_, teng_, worst):
    """Free lists and block tables bit for bit, pos/len exact, the recurrent
    state and the KV of admitted lanes of every row holding a stream within
    ATOL (the largest difference of each leaf goes into ``worst``).  Rows
    without a stream and lanes at pos -1 may differ (the port's trunk
    drafting writes the draft arena in place at pos -1)."""
    live = sorted(jeng_.streams)
    for jp, tp in ((jeng_.tpool, teng_.tpool), (jeng_.dpool, teng_.dpool)):
        assert tp._free == jp._free
        assert hasattr(tp, "_tbl") == hasattr(jp, "_tbl")
        if hasattr(jp, "_tbl"):
            np.testing.assert_array_equal(tp._tbl, jp._tbl)
            assert tp._free_blocks == jp._free_blocks
        rows = range(jp.n_slots)
        jv = jax.tree.map(np.asarray, jc.gather_streams(jp.cache, rows))
        tv = bridge.cache_to_numpy(tc.gather_streams(tp.cache, rows))
        assert sorted(jv) == sorted(tv)
        for key in jv:
            if key == "attn":
                np.testing.assert_array_equal(tv[key]["pos"], jv[key]["pos"])
                np.testing.assert_array_equal(tv[key]["len"], jv[key]["len"])
                adm = (jv[key]["pos"] >= 0) & np.isin(np.arange(jp.n_slots), live)[:, None]
                for name in ("k", "v"):
                    _close(worst, name, tv[key][name][:, adm], jv[key][name][:, adm])
            elif key == "len":
                np.testing.assert_array_equal(tv[key], jv[key])
            else:
                _close(worst, key, _rows(key, tv[key])[live], _rows(key, jv[key])[live])


def _lockstep(family, verifier, worst=None, **kw):
    """Step the JAX engine and the port's on the same requests, holding
    their pools equal after every step; returns each one's ((tokens,
    reason) per request, counters), JAX first.  ``worst`` collects the
    largest pool difference of each leaf."""
    worst = {} if worst is None else worst
    engs = []
    for mod, emod, args in ((jbe, jeng, family["jax"]), (tbe, teng, family["torch"])):
        eng = mod.BatchedSpeculativeEngine(*args, emod.EngineConfig(verifier, *ACTION, max_cache=64), n_slots=3,
                                           block_size=8, **kw)
        if mod is jbe:
            eng._jit_cache = family["jit"]
        assert eng.strategy == "replay" and not getattr(eng, "_ragged_ok")
        engs.append(eng)
    rids = [[e.submit(list(p), max_new=m, seed=s) for p, m, s in zip(PROMPTS, MAX_NEW, SEEDS)] for e in engs]
    while engs[0].queue or engs[0].streams:
        for e in engs:
            e.step()
        _same_pools(*engs, worst)
    assert not (engs[1].queue or engs[1].streams)
    return [([(e.finished[r]["tokens"], e.finished[r]["reason"]) for r in rs], _counters(e))
            for e, rs in zip(engs, rids)]


LOCKSTEP_CASES = [("specinfer", True, False), ("specinfer", False, True), ("traversal", True, True),
                  ("greedy_mpbv", False, False), ("greedy_mpbv", True, True)]


@pytest.mark.parametrize("verifier,paged,pipeline", LOCKSTEP_CASES)
def test_batched_engine_matches_jax(family, verifier, paged, pipeline):
    (want, wc), (got, c) = _lockstep(family, verifier, paged=paged, pipeline=pipeline)
    assert got == want
    assert {k: c[k] for k in wc} == wc
    assert c["accepted"] > 0 and c["ragged_calls"] == c["padded_calls"] == 0
    if pipeline:
        assert c["pipeline_ahead"] > 0


def test_replay_leaves_the_target_pool_until_the_commit(family):
    """begin_step's trunk and branch replay read the committed snapshot and
    write only copies: the target pool is the snapshot, bit for bit, until
    commit_step writes the re-advanced rows back."""
    eng = tbe.BatchedSpeculativeEngine(*family["torch"], teng.EngineConfig("specinfer", *ACTION, max_cache=64),
                                       n_slots=3, block_size=8, pipeline=False)
    for p, m, s in zip(PROMPTS[:2], MAX_NEW[:2], SEEDS[:2]):
        eng.submit(list(p), max_new=m, seed=s)
    eng.step()
    pending = eng.begin_step()
    before = jax.tree.map(np.copy, bridge.cache_to_numpy(pending.snapshot))
    assert pending.snapshot is eng.tpool.cache
    v = eng.verify_step(pending)
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(eng.tpool.cache)), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)
    eng.commit_step(v)
    assert eng.tpool.cache is not pending.snapshot
    eng.retire_step(v)


def test_abort_rolls_the_recurrent_draft_back(family):
    """A pipelined begin_step holds the draft pool's back frame (a copy);
    abort_step restores the draft pool bit for bit, and the rng snapshots."""
    eng = tbe.BatchedSpeculativeEngine(*family["torch"], teng.EngineConfig("specinfer", *ACTION, max_cache=64),
                                       n_slots=3, block_size=8, pipeline=True)
    for p, m, s in zip(PROMPTS[:2], MAX_NEW[:2], SEEDS[:2]):
        eng.submit(list(p), max_new=m, seed=s)
    eng.step()
    pending, eng._pending_next = eng._pending_next, None
    eng.abort_step(pending)
    before = jax.tree.map(np.copy, bridge.cache_to_numpy(eng.dpool.cache))
    state = {s: st["rng"].bit_generator.state for s, st in eng.streams.items()}
    pending = eng.begin_step()
    assert eng.dpool.frame_held
    eng.abort_step(pending)
    assert not eng.dpool.frame_held
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(eng.dpool.cache)), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)
    assert {s: st["rng"].bit_generator.state for s, st in eng.streams.items()} == state


def test_submit_mid_run_rewinds_exactly(family):
    """A request submitted while a step is begun ahead (a row free) rewinds
    that step through the back frame: the tokens equal the synchronous
    engine's."""
    outs = []
    for pipeline in (True, False):
        eng = tbe.BatchedSpeculativeEngine(*family["torch"], teng.EngineConfig("traversal", *ACTION, max_cache=64),
                                           n_slots=3, block_size=8, pipeline=pipeline)
        rids = [eng.submit(PROMPTS[i], max_new=MAX_NEW[i], seed=SEEDS[i]) for i in range(2)]
        for _ in range(2):
            eng.step()
        rids.append(eng.submit(PROMPTS[2], max_new=MAX_NEW[2], seed=SEEDS[2]))
        done = eng.run()
        outs.append([done[r]["tokens"] for r in rids])
    assert outs[0] == outs[1]


if __name__ == "__main__":
    # the largest pool difference of each leaf over every lockstep case:
    #   PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_replay.py
    for name in KW:
        worst = {}
        fam = family.__wrapped__(type("Request", (), {"param": name}))
        for verifier, paged, pipeline in LOCKSTEP_CASES:
            _lockstep(fam, verifier, worst, paged=paged, pipeline=pipeline)
        print(name, {k: f"{v:.3e}" for k, v in sorted(worst.items())}, f"(ATOL {ATOL})")
