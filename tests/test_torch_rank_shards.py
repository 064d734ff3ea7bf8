"""The port's sharded engine with one shard a rank, on ``gloo`` ranks on the
CPU, against JAX's ``ShardedBatchedSpeculativeEngine`` in one process.

Two spawns (tests/_dist_ranks.py; the ranks import torch and the port
only, and run while this process computes the JAX references), float32
smoke models with JAX's weights bridged:

  * granite-8b's smoke and its ``make_draft_cfg`` draft on 2 ranks, tree
    strategy, paged (a small arena: one shard refuses an admission and the
    request goes to the other), ragged auto, pipelined, specinfer: 4
    requests, 3 steps, 3 more, then to the end.  Tokens, reasons, routing,
    the pool occupancy after every step and the summed counters (apart
    from the commit's: a shard a rank commits alone, JAX groups) equal
    JAX's, and the ranks exchange once a step (once more at the submit that
    finishes a begun step whose boundary evicted).  Then on the same ranks:
    the refusals, a rank that raises mid-run failing every rank, and
    ``launch.serve --distributed --device cpu --smoke --streams 4
    --data-shards 2``, whose tokens are the single-process
    ``--data-shards 2``'s;
  * mamba2-2.7b's smoke on 3 ranks, replay strategy, ``n_slots`` 4 (padded
    to 6), traversal, synchronous: tokens equal JAX's.
"""
import contextlib
import io
import pickle
import re
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np

from _dist_ranks import Ranks, serve_plan
from repro.configs import get_smoke as j_get_smoke
from repro.launch.serve import make_draft_cfg as j_make_draft_cfg
from repro.models.transformer import init_params as j_init_params
from repro.serving import batch_engine as jbe
from repro.serving import engine as jeng
from repro_torch.launch import serve as tserve

TREE_ECFG = dict(verifier="specinfer", K=2, L1=2, L2=2, max_cache=64)
# 2 shards of 2 rows and 8 blocks of 8 slots.  After three steps the 40-token stream fills its
# 64-slot ring, and shard 0's begun-ahead boundary evicts it (the submit that follows finishes
# that step: one exchange more); shard 0 then has a free row but 2 free blocks, so the
# 12-token request (3 blocks) goes to shard 1
TREE_ENGINE = dict(n_slots=4, data_shards=2, block_size=8, pool_blocks=16, pipeline=True, ragged=True)
REPLAY_ECFG = dict(verifier="traversal", K=2, L1=1, L2=1, max_cache=64)
REPLAY_ENGINE = dict(n_slots=4, data_shards=3, pipeline=False)
LAUNCHER = ["--device", "cpu", "--smoke", "--arch", "granite-8b", "--streams", "4", "--data-shards", "2",
            "--requests", "6", "--max-new", "8"]


def _requests(vocab, lens, max_news, seed0):
    rng = np.random.default_rng(seed0)
    return [(rng.integers(0, vocab, size=n).tolist(), m, seed0 + i) for i, (n, m) in enumerate(zip(lens, max_news))]


def _models(arch, path):
    """JAX's float32 smoke ``arch`` and its draft, with their parameters
    pickled as numpy to ``path`` for the ranks (arguments that large would
    hold each spawn's start until the child has imported torch)."""
    cfg = j_get_smoke(arch).replace(dtype="float32")
    dcfg = j_make_draft_cfg(cfg)
    init = jax.jit(j_init_params, static_argnums=0)
    tp, dp = init(cfg, jax.random.PRNGKey(0)), init(dcfg, jax.random.PRNGKey(1))
    with open(path, "wb") as f:
        pickle.dump((jax.tree.map(np.asarray, tp), jax.tree.map(np.asarray, dp)), f)
    return cfg, tp, dcfg, dp, str(path)


def _jax_plan(models, ecfg_kw, engine_kw, plan):
    """``plan`` through JAX's sharded engine in one process, recorded as
    the ranks record it."""
    cfg, tp, dcfg, dp = models[:4]
    eng = jbe.ShardedBatchedSpeculativeEngine(cfg, tp, dcfg, dp, jeng.EngineConfig(**ecfg_kw), **engine_kw)
    eng._jit_cache = {}
    for sh in eng.shards:
        sh._jit_cache = eng._jit_cache
    return serve_plan(eng, plan, busy=lambda: eng.queue or eng.streams)


def _no_commit(counters):
    return {k: v for k, v in counters.items() if k not in ("commit_calls", "commit_ms")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, started first; the JAX references (the replay one in a
    thread beside the tree one) and the single-process launcher's output
    computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("rank_shards")
    tree, replay = _models("granite-8b", tmp / "tree.pkl"), _models("mamba2-2.7b", tmp / "replay.pkl")
    reqs = _requests(tree[0].vocab, [40, 6, 6, 6, 12, 6, 6], [40, 1, 30, 12, 10, 8, 10], 10)
    tree_plan = [("submit", reqs[:4]), ("steps", 3), ("submit", reqs[4:])]
    replay_plan = [("submit", _requests(replay[0].vocab, [4] * 4, [5, 7, 4, 6], 30))]
    ranks_tree = Ranks("rank_shards_tree", 2, str(tmp / "tree"),
                       (tree[4], "granite-8b", TREE_ECFG, TREE_ENGINE, tree_plan, ["--distributed"] + LAUNCHER))
    ranks_replay = Ranks("rank_shards_replay", 3, str(tmp / "replay"),
                         (replay[4], "mamba2-2.7b", REPLAY_ECFG, REPLAY_ENGINE, replay_plan))
    with ThreadPoolExecutor(1) as pool:
        want_replay = pool.submit(_jax_plan, replay, REPLAY_ECFG, REPLAY_ENGINE, replay_plan)
        want_tree = _jax_plan(tree, TREE_ECFG, TREE_ENGINE, tree_plan)
        want_replay = want_replay.result()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(LAUNCHER)
    return {"tree": (want_tree, ranks_tree.result(timeout=150)),
            "replay": (want_replay, ranks_replay.result(timeout=150)), "launcher": out.getvalue()}


def test_tree_ranks_serve_jax_tokens_and_routing(runs):
    want, got = runs["tree"]
    assert got["outs"] == want["outs"] and got["routing"] == want["routing"]
    assert sorted(set(got["routing"])) == [0, 1] and got["routing"][4] == 1  # routed around shard 0
    assert [reason for _, reason in got["outs"]].count("length") == 5
    assert got["outs"][0][1] == "evicted:cache_full"


def test_tree_ranks_counters_and_pools_equal_jax(runs):
    want, got = runs["tree"]
    assert got["steps"] == want["steps"] and got["occupancy"] == want["occupancy"]
    assert {k: got["counters"][k] for k in _no_commit(want["counters"])} == _no_commit(want["counters"])
    assert got["counters"]["admit_blocked"] > 0 and got["counters"]["ragged_calls"] > 0
    # a shard a rank commits alone: once a shard step, none grouped
    assert got["engine_counters"]["commit_calls"] == 0
    assert got["counters"]["commit_calls"] >= want["counters"]["commit_calls"] > 0


def test_tree_ranks_exchange_once_a_step(runs):
    _, got = runs["tree"]
    ex = got["exchanges"]
    assert ex == {"step": got["steps"], "submit": 1, "pipeline": 0}
    assert got["gathers"] == sum(ex.values())  # every collective is an exchange the engine counted
    # rank 0 holds its own shard and a record of the other
    assert got["n_shards"] == 2 and got["held"] == "ShardRecord"


def test_rank_refusals_and_a_failing_rank(runs):
    _, got = runs["tree"]
    assert "the process group has 2 ranks for 3 shards" in got["refusals"]["group size"]
    assert "shards live on cuda or cpu, not 'meta'" in got["refusals"]["weights' device"]
    assert got["failure"] is not None and "rank 1 failed" in got["failure"]
    assert "verification failed on purpose" in got["failure"]


def test_launcher_distributed_prints_single_process_tokens(runs):
    _, got = runs["tree"]
    want = re.findall(r"^req\d+: .*$", runs["launcher"], re.M)
    assert len(want) == 6 and re.findall(r"^req\d+: .*$", got["launcher"], re.M) == want
    assert "ranks=2(a shard each, exchanges=" in got["launcher"]


def test_replay_ranks_serve_jax_tokens(runs):
    want, got = runs["replay"]
    assert got["n_slots"] == 6 and got["local_slots"] == 2  # 4 rows padded to 3 shards of 2
    assert got["outs"] == want["outs"] and got["routing"] == want["routing"]
    assert sorted(set(got["routing"])) == [0, 1, 2]
    assert got["exchanges"] == {"step": got["steps"], "submit": 0, "pipeline": 0} and got["steps"] == want["steps"]
    assert {k: got["counters"][k] for k in _no_commit(want["counters"])} == _no_commit(want["counters"])


def test_shard_meshes_names_its_device():
    from repro_torch.launch.mesh import shard_meshes

    assert shard_meshes(3, "cpu") == [torch.device("cpu")] * 3
    assert shard_meshes(3, ["cpu", "meta"]) == [torch.device("cpu"), torch.device("meta"), torch.device("cpu")]
    with pytest.raises(ValueError, match="not 'cuda:1'"):
        shard_meshes(2, "cuda:1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no device is visible"):
            shard_meshes(2, "cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            tserve.main(["--distributed"] + LAUNCHER[2:] + ["--device", "cuda"])
