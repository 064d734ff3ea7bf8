"""The port's sharded continuous-batching engine against the JAX package, on
the CPU, in float32 with weights bridged from JAX.

  * the pool stream-axis rules (``pad_slots``, ``pool_specs``,
    ``pool_shardings``) and ``shard_meshes``, as tests/test_sharding.py
    holds the JAX ones; every shard's pool lives on the weights' device;
  * the port's ``ShardedBatchedSpeculativeEngine`` against the JAX one:
    tokens, routing (``shard_of``), summed and engine-level counters and
    per-shard ``pool_occupancy`` equal, on the tree strategy (specinfer
    pipelined, traversal sync, greedy_mpbv) and the replay strategy (the
    ssm smoke, specinfer);
  * sharded == unsharded for the four verifiers x sync and pipelined, on
    both strategies, and the mirrors of the JAX property suite: continuous
    admission, eviction identity, shard-local pressure eviction, routing
    around an exhausted shard, the multi-shard abort and bin-packing;
  * the commit counters and the grouping rule of tests/test_counters.py,
    with the launch rule of the grouped commit (one ``commit_kv`` a shard);
  * a shuffled ``_finish_order`` keeps tokens and counters
    (tests/test_race.py);
  * ``repro_torch.launch.serve --data-shards 2`` prints the tokens of
    ``--data-shards 1``.
"""
import re
import time

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init_params
from repro.serving import batch_engine as jbe
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import shard_meshes
from repro_torch.launch.sharding import pad_slots, pool_shardings, pool_specs
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.transformer import init_cache
from repro_torch.serving import batch_engine as tbe
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_step

V = 32
DENSE_T = dict(name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=V,
               dtype="float32")
DENSE_D = dict(name="d", arch_type="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=96, vocab=V,
               dtype="float32")
SSM = dict(name="s", arch_type="ssm", n_layers=2, d_model=48, vocab=V, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
           dtype="float32")
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [3, 1]]
SEEDS = [20, 21, 22, 23]
ACTION = (2, 1, 1)


def _bridge(p):
    return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    """{family: {"jax": (tc, tp, dc, dp), "torch": (...)}}: the dense pair of
    tests/test_sharding.py, and the ssm smoke with a draft from another key
    (with draft == target, greedy_mpbv's ratios are all 1 up to rounding:
    ROADMAP queue 3)."""
    out = {}
    for fam, (tkw, dkw) in {"dense": (DENSE_T, DENSE_D), "ssm": (SSM, SSM)}.items():
        jt, jd = JConfig(**tkw), JConfig(**dkw)
        init = jax.jit(j_init_params, static_argnums=0)
        jtp, jdp = init(jt, jax.random.PRNGKey(0)), init(jd, jax.random.PRNGKey(1))
        out[fam] = {"jax": (jt, jtp, jd, jdp), "torch": (TConfig(**tkw), _bridge(jtp), TConfig(**dkw), _bridge(jdp))}
    return out


def _ecfg(mod, verifier="specinfer", max_cache=128, action=ACTION):
    return mod.EngineConfig(verifier, *action, max_cache=max_cache)


def _sharded(models, fam="dense", verifier="specinfer", max_cache=128, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("data_shards", 2)
    return tbe.ShardedBatchedSpeculativeEngine(*models[fam]["torch"], _ecfg(teng, verifier, max_cache), **kw)


def _unsharded(models, fam="dense", verifier="specinfer", max_cache=128, **kw):
    kw.setdefault("n_slots", 4)
    return tbe.BatchedSpeculativeEngine(*models[fam]["torch"], _ecfg(teng, verifier, max_cache), **kw)


def _no_ms(counters):
    return {k: v for k, v in counters.items() if k != "commit_ms"}


# ----------------------------------------------------------- stream axis ---


def test_pool_specs_stream_axis():
    cfg, ssm = TConfig(**DENSE_T), TConfig(**SSM)
    sp = pool_specs({"data": 4, "model": 2}, init_cache(cfg, 8, 32, "cpu", True))
    assert (sp["attn"]["k"], sp["attn"]["v"], sp["attn"]["pos"], sp["attn"]["len"]) == (1, 1, 0, 0)
    # a paged arena has no stream axis: each shard owns a private arena instead
    sp = pool_specs({"data": 4}, init_cache(cfg, 8, 32, "cpu", True, (8, 8)))
    assert (sp["attn"]["k"], sp["attn"]["v"], sp["attn"]["block_tbl"], sp["attn"]["pos"]) == (None, None, 0, 0)
    sp = pool_specs({"data": 2}, init_cache(ssm, 8, 32, "cpu", True))
    assert (sp["state"], sp["conv"], sp["len"]) == (1, 1, 0)


def test_pool_stream_axis_must_divide():
    """The stream axis never drops: pad n_slots instead of replicating a shard."""
    with pytest.raises(ValueError, match="pad n_slots"):
        pool_specs({"data": 2}, init_cache(TConfig(**DENSE_T), 3, 32, "cpu", True))
    assert [pad_slots(3, 2), pad_slots(4, 2), pad_slots(1, 4), pad_slots(5, 1)] == [4, 4, 4, 5]
    with pytest.raises(ValueError, match="data"):
        pool_specs({"model": 2}, init_cache(TConfig(**DENSE_T), 2, 32, "cpu", True))


def test_shard_pools_live_on_their_devices(models):
    eng = _sharded(models, max_cache=64)
    assert [sh.n_slots for sh in eng.shards] == [2, 2] and [sh.shard_id for sh in eng.shards] == [0, 1]
    for sh in eng.shards:
        for pool in (sh.tpool, sh.dpool):
            leaves = [t for v in pool.cache.values() for t in (v.values() if isinstance(v, dict) else [v])]
            assert {t.device for t in leaves} == {sh.mesh} == {torch.device("cpu")}
    odd = _sharded(models, n_slots=3, max_cache=64)  # padded up, not replicated
    assert odd.n_slots == 4 and [sh.n_slots for sh in odd.shards] == [2, 2]
    assert shard_meshes(3, devices=["cpu"]) == [torch.device("cpu")] * 3
    assert len(shard_meshes(3)) == 3
    with pytest.raises(NotImplementedError, match="8b"):  # one pool over several devices
        pool_shardings(["cpu", "cpu"], init_cache(TConfig(**DENSE_T), 2, 32, "cpu", True))
    with pytest.raises(ValueError, match="8b"):  # a shard away from its weights
        _unsharded(models, max_cache=64, mesh=torch.device("meta"))


# --------------------------------------------------- the port against JAX ---


def _serve_both(models, fam, verifier, pipeline, max_news):
    """Serve PROMPTS through the JAX and the port's sharded engines; returns
    per engine (tokens and reasons, routing, summed counters, engine-level
    counters, per-shard pool occupancy), JAX first."""
    res = []
    for bmod, emod, side in ((jbe, jeng, "jax"), (tbe, teng, "torch")):
        eng = bmod.ShardedBatchedSpeculativeEngine(*models[fam][side], _ecfg(emod, verifier, 64), n_slots=4,
                                                   data_shards=2, block_size=8, pipeline=pipeline)
        rids = [eng.submit(list(p), max_new=m, seed=s) for p, m, s in zip(PROMPTS, max_news, SEEDS)]
        routing = [eng.shard_of(r) for r in rids]
        occ = []
        while eng.queue or eng.streams:
            eng.step()
            occ.append(eng.pool_occupancy())
        outs = eng.finished
        res.append(([(outs[r]["tokens"], outs[r]["reason"]) for r in rids], routing, _no_ms(eng.counters),
                    _no_ms(eng._counters), occ))
    return res


@pytest.mark.parametrize("fam,verifier,pipeline", [
    ("dense", "specinfer", True), ("dense", "traversal", False), ("dense", "greedy_mpbv", True),
    ("ssm", "specinfer", True)])
def test_sharded_engine_matches_jax(models, fam, verifier, pipeline):
    want, got = _serve_both(models, fam, verifier, pipeline, [10, 6, 12, 8])
    assert got[:2] == want[:2]  # tokens, finish reasons and routing
    assert {k: got[2][k] for k in want[2]} == want[2]
    assert got[3] == want[3] and got[4] == want[4]
    c = got[2]
    assert c["accepted"] > 0 and sorted(set(got[1])) == [0, 1]
    if fam == "dense":  # tree shards commit together
        assert got[3]["commit_calls"] > 0 and got[4][0]["per_shard"][0]["target"]["blocks_used"] > 0
    else:  # the replay strategy commits shard by shard
        assert got[3]["commit_calls"] == 0 and c["commit_calls"] > 0


# ---------------------------------------------- sharded == unsharded tokens ---


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("verifier", ["specinfer", "traversal", "univer", "greedy_mpbv"])
@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_sharded_matches_unsharded(models, fam, verifier, pipeline):
    max_new = 12 if fam == "dense" else 8
    ref = _unsharded(models, fam, verifier, pipeline=pipeline).generate_batch(PROMPTS, max_new=max_new, seeds=SEEDS)
    eng = _sharded(models, fam, verifier, pipeline=pipeline)
    assert eng.strategy == ("tree" if fam == "dense" else "replay")
    assert eng.generate_batch(PROMPTS, max_new=max_new, seeds=SEEDS) == ref
    assert all(sh.counters["blocks"] > 0 for sh in eng.shards)  # both shards served


def test_sharded_continuous_admission_exact(models):
    """More requests than rows: each shard's FIFO admits as its rows free up;
    tokens still equal the unsharded pool's."""
    prompts = [[i + 1, i + 2] for i in range(6)]
    max_news = [6, 14, 10, 8, 12, 9]
    seeds = [30 + i for i in range(6)]
    base = _unsharded(models, pipeline=False)
    rids = [base.submit(p, max_new=m, seed=s) for p, m, s in zip(prompts, max_news, seeds)]
    outs = base.run()
    ref = [outs[r]["tokens"] for r in rids]
    eng = _sharded(models, pipeline=True)
    rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in zip(prompts, max_news, seeds)]
    sout = eng.run()
    assert [sout[r]["tokens"] for r in rids] == ref
    assert all(sh.tpool.free_slots == sh.n_slots for sh in eng.shards)


def test_sharded_eviction_identity(models):
    """Capacity eviction fires at the same step sharded and unsharded: with a
    homogeneous action the bound C - 1 + Tpad is per stream."""
    prompts, seeds = [[1, 2, 3], [4, 5]], [7, 9]
    base = _unsharded(models, max_cache=24, n_slots=2)
    brids = [base.submit(p, max_new=64, seed=s) for p, s in zip(prompts, seeds)]
    bouts = base.run()
    assert all(bouts[r]["reason"].startswith("evicted") for r in brids)
    eng = _sharded(models, max_cache=24, n_slots=2)
    srids = [eng.submit(p, max_new=64, seed=s) for p, s in zip(prompts, seeds)]
    assert [eng.shard_of(r) for r in srids] == [0, 1]
    souts = eng.run()
    assert [souts[r] for r in srids] == [bouts[r] for r in brids]
    assert sum(sh.counters["evicted"] for sh in eng.shards) == 2


def test_pressure_eviction_is_shard_local(models):
    """Block pressure in one shard evicts from that shard only (LIFO); the
    other shard's streams emit their independent single-stream tokens."""
    eng = _sharded(models, max_cache=64, block_size=16, pool_blocks=10)  # 5 a shard < 2 rings
    rid_a = eng.submit([1, 2, 3], max_new=64, seed=40)
    rid_b = eng.submit([4, 5], max_new=4, seed=41)
    rid_c = eng.submit([6, 7], max_new=64, seed=42)
    rid_d = eng.submit([8, 9], max_new=4, seed=43)
    assert [eng.shard_of(r) for r in (rid_a, rid_b, rid_c, rid_d)] == [0, 1, 0, 1]
    outs = eng.run()
    assert outs[rid_c]["reason"] == "evicted:pool_blocks"
    assert outs[rid_a]["reason"].startswith("evicted")
    assert eng.shards[0].counters["evicted"] == 2
    assert eng.shards[1].counters["evicted"] == 0 and eng.shards[1].counters["blocks_reclaimed"] == 0
    for rid, prompt, seed in ((rid_b, [4, 5], 41), (rid_d, [8, 9], 43)):
        single = teng.SpeculativeEngine(*models["dense"]["torch"],
                                        teng.EngineConfig("specinfer", *ACTION, max_cache=64, seed=seed))
        assert outs[rid]["tokens"] == single.generate(prompt, max_new=4)


def test_admission_routes_around_exhausted_shard(models):
    """A shard whose free list is dry does not take a request another shard
    can admit now."""
    eng = _sharded(models, max_cache=64, block_size=16, pool_blocks=8)  # 4 a shard
    long_prompt = [(i % (V - 2)) + 1 for i in range(44)]
    rid_a = eng.submit(long_prompt, max_new=8, seed=50)
    assert eng.shard_of(rid_a) == 0
    eng.step()  # admits A: its context maps 3 of shard 0's 4 blocks
    s0 = eng.shards[0]
    assert s0.tpool.free_slots > 0, "exhaustion must come from blocks, not rows"
    assert all(p.free_blocks < 2 for p in s0._paged_pools())
    rid_b = eng.submit([3, 1, 4, 1] * 5, max_new=4, seed=51)  # needs 2 blocks
    assert eng.shard_of(rid_b) == 1
    outs = eng.run()
    assert len(outs[rid_b]["tokens"]) == 4
    assert s0.counters["admit_blocked"] == 0


def test_multi_shard_abort_rewinds_all(models):
    """``abort_pipeline`` with both shards begun ahead rewinds both, so the
    continued run emits the synchronous sharded tokens."""
    want = _sharded(models, pipeline=False).generate_batch(PROMPTS, max_new=12, seeds=SEEDS)
    eng = _sharded(models, pipeline=True)
    rids = [eng.submit(list(p), max_new=12, seed=s) for p, s in zip(PROMPTS, SEEDS)]
    eng.step()
    assert sum(sh._pending_next is not None for sh in eng.shards) == 2
    assert eng.abort_pipeline() == 2
    assert all(sh._pending_next is None for sh in eng.shards)
    assert not any(sh.dpool.frame_held for sh in eng.shards)
    assert eng.abort_pipeline() == 0
    outs = eng.run()
    assert [outs[r]["tokens"] for r in rids] == want


# ------------------------------------------------------------ bin-packing ---


def test_bin_packing_groups_similar_actions(models):
    eng = _sharded(models)
    big, thin = (4, 2, 4), (1, 1, 0)
    rids = [eng.submit(list(p), max_new=4, seed=s, action_hint=h)
            for p, s, h in zip(PROMPTS, SEEDS, [big, thin, big, thin])]
    shards = [eng.shard_of(r) for r in rids]
    assert shards[0] == shards[2] and shards[1] == shards[3] and shards[0] != shards[1]
    outs = eng.run()
    assert all(len(outs[r]["tokens"]) == 4 for r in rids)


def test_bin_packing_deterministic_and_output_invariant(models):
    hints = [(4, 2, 4), (1, 1, 0), (1, 1, 0), (4, 2, 4)]

    def serve(with_hints):
        eng = _sharded(models)
        rids = [eng.submit(list(p), max_new=8, seed=s, action_hint=h if with_hints else None)
                for p, s, h in zip(PROMPTS, SEEDS, hints)]
        placed = [eng.shard_of(r) for r in rids]
        outs = eng.run()
        return placed, [outs[r]["tokens"] for r in rids]

    placed_a, outs_a = serve(True)
    assert serve(True) == (placed_a, outs_a)
    assert placed_a == [0, 1, 1, 0]
    placed_free, outs_free = serve(False)
    assert placed_free == [0, 1, 0, 1]
    assert outs_free == outs_a, "hints must never change emitted tokens"


def test_bin_packing_homogeneous_hints_degrade_to_least_loaded(models):
    eng = _sharded(models)
    rids = [eng.submit(list(p), max_new=4, seed=s, action_hint=ACTION) for p, s in zip(PROMPTS, SEEDS)]
    assert [eng.shard_of(r) for r in rids] == [0, 1, 0, 1]
    eng.run()


# --------------------------------------------------------------- counters ---


@pytest.fixture
def commit_tally(monkeypatch):
    """Ground truth independent of the counters: every commit call the batch
    engine makes (an engine's own, or a grouped one; both go through
    ``make_group_commit_step``), and every ``pool_commit_kv`` (the
    ``commit_kv`` wrapper's call site) it reaches."""
    tally = {"commits": 0, "kernel": 0}

    def counting(factory, key):
        def make(*a, **kw):
            fn = factory(*a, **kw)

            def call(*ca, **ckw):
                tally[key] += 1
                return fn(*ca, **ckw)
            return call
        return make

    monkeypatch.setattr(tbe, "make_group_commit_step", counting(tbe.make_group_commit_step, "commits"))
    kernel = serve_step.pool_commit_kv

    def counted_kernel(*a, **kw):
        tally["kernel"] += 1
        return kernel(*a, **kw)

    monkeypatch.setattr(serve_step, "pool_commit_kv", counted_kernel)
    return tally


def test_single_engine_commit_counters(models, commit_tally):
    eng = _unsharded(models, pipeline=False)
    eng.profile_commits = True
    t0 = time.perf_counter()
    eng.generate_batch(PROMPTS, max_new=10, seeds=SEEDS)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert eng.counters["commit_calls"] == commit_tally["commits"] == commit_tally["kernel"] > 0
    assert 0 < eng.counters["commit_ms"] <= wall_ms


def test_sharded_commit_counters_and_grouping(models, commit_tally):
    single = _unsharded(models, pipeline=False)
    want = single.generate_batch(PROMPTS, max_new=10, seeds=SEEDS)
    single_commits = single.counters["commit_calls"]
    commit_tally.update(commits=0, kernel=0)
    eng = _sharded(models, pipeline=False)
    eng.profile_commits = True
    assert eng.profile_commits and all(sh.profile_commits for sh in eng.shards)
    assert eng.generate_batch(PROMPTS, max_new=10, seeds=SEEDS) == want
    c = eng.counters
    # the summed counter equals the commit calls that happened...
    assert c["commit_calls"] == commit_tally["commits"] > 0
    # ...the grouped path fired (engine-level, no shard owns it), launching
    # the commit kernel once a shard...
    grouped = eng.grouped_commits
    assert grouped > 0 and c["commit_ms"] > 0
    per_shard = sum(sh.counters["commit_calls"] for sh in eng.shards)
    assert commit_tally["kernel"] == per_shard + eng.data_shards * grouped
    # ...and regrouping keeps the commit calls within one straggler a shard
    assert c["commit_calls"] <= single_commits + eng.data_shards
    eng.reset_counters(("commit_calls", "commit_ms"))
    assert eng.counters["commit_calls"] == 0 and eng.counters["commit_ms"] == 0.0


# ---------------------------------------------------------- race harness ---


class ShuffledShardedEngine(tbe.ShardedBatchedSpeculativeEngine):
    """Verifies the begun shards in a seeded random order each step: the
    stand-in for whichever shard's device finishes first."""

    def init_shuffle(self, seed):
        self.order_rng = np.random.default_rng(seed)
        self.orders_seen = set()

    def _finish_order(self, sis):
        order = list(sis)
        self.order_rng.shuffle(order)
        self.orders_seen.add(tuple(order))
        return order


def _trace(eng, scenario, rnd):
    base = 100 + 10 * rnd
    if scenario == "evict":
        rids = [eng.submit([1, 2, 3], max_new=64, seed=base), eng.submit([4, 5], max_new=64, seed=base + 1)]
    elif scenario == "midsubmit":
        rids = [eng.submit([1, 2, 3], max_new=10, seed=base), eng.submit([4, 5], max_new=6, seed=base + 1)]
        eng.step()
        eng.step()
        rids += [eng.submit([6, 7, 8], max_new=8, seed=base + 2), eng.submit([2, 1], max_new=12, seed=base + 3)]
    else:
        rids = [eng.submit(p, max_new=m, seed=base + i)
                for i, (p, m) in enumerate(zip([[1, 2, 3], [4, 5], [6, 7, 8], [2, 1]], [6, 14, 10, 8]))]
    outs = eng.run()
    return [(outs[r]["tokens"], outs[r]["reason"]) for r in rids]


def test_shuffled_finish_order_keeps_identity_and_counters(models):
    args = models["dense"]["torch"]
    ecfg = teng.EngineConfig("specinfer", *ACTION, max_cache=32)
    eng = ShuffledShardedEngine(*args, ecfg, n_slots=4, data_shards=2, pipeline=True)
    eng.init_shuffle(1234)
    oracle = tbe.ShardedBatchedSpeculativeEngine(*args, ecfg, n_slots=4, data_shards=2, pipeline=False)
    saw_eviction = False
    for rnd in range(9):  # 3 scenarios x 3 seeded permutations each
        scenario = ("plain", "midsubmit", "evict")[rnd % 3]
        eng.reset_counters(("pipeline_ahead", "pipeline_stalls", "pipeline_iterations"))
        got = _trace(eng, scenario, rnd)
        assert got == _trace(oracle, scenario, rnd), (rnd, scenario)
        for sh in eng.shards:
            c = sh.counters
            assert c["pipeline_ahead"] + c["pipeline_stalls"] == c["pipeline_iterations"], (rnd, scenario)
        assert all(sh._pending_next is None for sh in eng.shards)
        assert all(sh.tpool.free_slots == sh.n_slots for sh in eng.shards)
        saw_eviction |= any(r.startswith("evicted") for _, r in got)
    assert saw_eviction, "no round exercised the eviction path"
    assert {(0, 1), (1, 0)} <= eng.orders_seen


# -------------------------------------------------------------------- CLI ---


def test_cli_data_shards_serves_the_unsharded_tokens(capsys):
    argv = ["--device", "cpu", "--smoke", "--arch", "granite-8b", "--streams", "4", "--requests", "6",
            "--max-new", "8"]
    outs = []
    for shards in ("1", "2"):
        tserve.main(argv + ["--data-shards", shards])
        out = capsys.readouterr().out
        outs.append(re.findall(r"^req\d+: .*$", out, re.M))
    assert len(outs[0]) == 6 and outs[1] == outs[0]
    assert "shards=2(x2 slots, peaks=[" in out and " grouped)" in out
