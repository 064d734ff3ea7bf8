"""The port's sharded engine against its own unsharded engine and the
properties the JAX package's suites hold, on the CPU, in float32 with the
weights of tests/test_torch_sharding.py (bridged from JAX):

  * sharded == unsharded for the four verifiers x sync and pipelined, on
    both strategies, and the mirrors of the JAX property suite: continuous
    admission, eviction identity, shard-local pressure eviction, routing
    around an exhausted shard, the multi-shard abort and bin-packing;
  * the commit counters and the grouping rule of tests/test_counters.py,
    with the launch rule of the grouped commit (one ``commit_kv`` a shard);
  * a shuffled ``_finish_order`` keeps tokens and counters
    (tests/test_race.py).
"""
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import numpy as np

from repro_torch.serving import batch_engine as tbe
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_step
from test_torch_sharding import ACTION, PROMPTS, SEEDS, V, _sharded, _unsharded
from test_torch_sharding import models  # noqa: F401  (the module-scoped fixture)


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
