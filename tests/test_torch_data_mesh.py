"""One pool over a data mesh: the port's ``BatchedSpeculativeEngine(...,
mesh=make_data_mesh(2))`` on two ``gloo`` ranks on the CPU, against JAX's
engine given ``make_data_mesh(2)`` over two forced CPU devices.

JAX fixes its device count once a process, so its reference runs in a child
process a case (tests/_jax_data_mesh.py, ``XLA_FLAGS=--xla_force_host_
platform_device_count=2``); the ranks (tests/_dist_ranks.py's ``data_mesh_serve``)
and the port's single-process engine run beside it.  Float32 smoke models
with JAX's weights bridged, two cases:

  * granite-8b's smoke and its ``make_draft_cfg`` draft, tree strategy,
    paged with a small arena (admissions blocked, one stream evicted for
    blocks), ragged auto, pipelined, specinfer: 4 requests, 3 steps (the
    40-token stream fills its 64-slot ring, and the begun-ahead boundary
    evicts it), 3 more, then to the end;
  * mamba2-2.7b's smoke on the replay strategy, traversal, pipelined, with
    ``n_slots`` ``pad_slots(3, 2)`` = 4 (a mesh-form engine does not pad by
    itself: JAX's ``pool_specs`` asserts).

Tokens, reasons, the pool occupancy after every step and the counters equal
JAX's on both ranks, and the port's single-process engine's; after every
step each rank's rows of both pools equal the single-process pools' rows
(attention K/V at the lanes a mask can admit) within 1e-5: the arena
replicas differ only outside a rank's own streams' blocks.  The ranks
exchange as the design says, refuse what JAX refuses, and a rank that
raises mid-run fails every rank.
"""
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np

from _dist_ranks import Ranks, _mesh_engine, held_rows, serve_pool_plan
from repro.configs import get_smoke as j_get_smoke
from repro.launch.serve import make_draft_cfg as j_make_draft_cfg
from repro.models.transformer import init_params as j_init_params
from repro_torch.launch.sharding import pad_slots

HERE = os.path.dirname(os.path.abspath(__file__))
TREE_ECFG = dict(verifier="specinfer", K=2, L1=2, L2=2, max_cache=64)
# 18 blocks of 8 slots for 4 rows of up to 8 blocks: admissions block, and one stream is evicted for blocks
TREE_ENGINE = dict(n_slots=4, block_size=8, pool_blocks=18, pipeline=True, ragged=True)
REPLAY_ECFG = dict(verifier="traversal", K=2, L1=1, L2=1, max_cache=64)
REPLAY_ENGINE = dict(n_slots=pad_slots(3, 2), pipeline=True)
CASES = ("tree", "replay")
TIMEOUT_S = 100


def _requests(vocab, lens, max_news, seed0):
    rng = np.random.default_rng(seed0)
    return [(rng.integers(0, vocab, size=n).tolist(), m, seed0 + i) for i, (n, m) in enumerate(zip(lens, max_news))]


def _weights(arch, path) -> str:
    """JAX's float32 smoke ``arch`` and its draft, their parameters pickled
    as numpy to ``path`` for the child and the ranks."""
    cfg = j_get_smoke(arch).replace(dtype="float32")
    init = jax.jit(j_init_params, static_argnums=0)
    tp, dp = init(cfg, jax.random.PRNGKey(0)), init(j_make_draft_cfg(cfg), jax.random.PRNGKey(1))
    with open(path, "wb") as f:
        pickle.dump((jax.tree.map(np.asarray, tp), jax.tree.map(np.asarray, dp)), f)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's child and the ranks, started first; the port's single-process
    runs made while they work."""
    tmp = tmp_path_factory.mktemp("data_mesh")
    tree_w, replay_w = _weights("granite-8b", tmp / "tree.pkl"), _weights("mamba2-2.7b", tmp / "replay.pkl")
    reqs = _requests(512, [40, 6, 6, 6, 30, 6, 6], [40, 1, 30, 12, 10, 8, 10], 10)
    cases = {"tree": (tree_w, "granite-8b", TREE_ECFG, TREE_ENGINE,
                      [("submit", reqs[:4]), ("steps", 3), ("submit", reqs[4:])]),
             "replay": (replay_w, "mamba2-2.7b", REPLAY_ECFG, REPLAY_ENGINE,
                        [("submit", _requests(512, [4] * 5, [5, 7, 4, 6, 5], 30))])}
    # two CPU devices for the mesh; LLVM's optimisation passes off, which cuts the children's compile
    # time (a third of their CPU) and leaves what XLA computes as it is (the same records either way)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true")
    children = {}
    for name, case in cases.items():  # a child a case, side by side
        with open(tmp / f"{name}.cases.pkl", "wb") as f:
            pickle.dump({name: case}, f)
        children[name] = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_jax_data_mesh.py"), str(tmp / f"{name}.cases.pkl"),
             str(tmp / f"{name}.jax.pkl")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ranks = Ranks("data_mesh_serve", 2, str(tmp / "init"), (cases, cases["tree"]))
    want = {}
    try:
        single = {name: serve_pool_plan(_mesh_engine(*case[:4], None), case[4], held_rows)
                  for name, case in cases.items()}
        got = ranks.result(timeout=TIMEOUT_S)
        for name, child in children.items():
            out, _ = child.communicate(timeout=TIMEOUT_S)
            assert child.returncode == 0, out.decode()[-4000:]
            with open(tmp / f"{name}.jax.pkl", "rb") as f:
                want.update(pickle.load(f))
    finally:
        for child in children.values():
            child.kill()
    return want, single, got


def _same_run(a, b):
    """``b``'s record in ``a``: tokens, reasons, steps, occupancy, and the
    counters ``b`` keeps (JAX's engine has no padded/ragged pass counts)."""
    assert a["outs"] == b["outs"] and a["steps"] == b["steps"]
    assert a["occupancy"] == b["occupancy"]
    assert {k: a["counters"][k] for k in b["counters"]} == b["counters"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_form_serves_jax_tokens_pools_and_counters(runs, case):
    want, _, got = runs
    for rank in (0, 1):
        _same_run(got[rank][case], want[case])
    reasons = [reason for _, reason in want[case]["outs"]]
    if case == "tree":
        assert reasons[0] == "evicted:cache_full" and "evicted:pool_blocks" in reasons
        c = got[0][case]["counters"]
        assert c["admit_blocked"] > 0 and c["ragged_calls"] > 0 and c["padded_calls"] > 0
    else:
        assert reasons == ["length"] * 5


@pytest.mark.parametrize("case", CASES)
def test_single_process_engine_serves_the_same(runs, case):
    want, single, got = runs
    _same_run(single[case], want[case])
    for rank in (0, 1):  # the port's own counters too
        assert got[rank][case]["counters"] == single[case]["counters"]


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_the_single_process_rows(runs, case):
    """After every step, rank r's rows [2r, 2r + 2) of both pools: the
    cache leaves of each live stream, attention K/V at its live lanes,
    equal the single-process pools' within 1e-5, and the ranks together
    hold every live stream once."""
    _, single, got = runs
    assert got[0][case]["rows"] == (0, 2) and got[1][case]["rows"] == (2, 4)
    assert got[0][case]["local_len"] == 2
    for step, want in enumerate(single[case]["records"]):
        mine = [got[r][case]["records"][step] for r in (0, 1)]
        assert sorted([*mine[0], *mine[1]]) == sorted(want), step
        for rank in (0, 1):
            for key, leaves in mine[rank].items():
                assert key[1] // 2 == rank
                for name, val in leaves.items():
                    ref = want[key][name]
                    if name in ("pos", "len"):
                        np.testing.assert_array_equal(val, ref, err_msg=f"step {step} {key} {name}")
                    else:
                        np.testing.assert_allclose(val, ref, atol=1e-5, rtol=0, err_msg=f"step {step} {key} {name}")


def test_mesh_form_exchanges_as_designed(runs):
    """Tree strategy: one exchange a draft pass and a target pass, one a
    boundary that admitted, nothing else; replay: one draft exchange for
    the grouped ingest and each draft level, one for the target's groups
    and one for the commit, a step.  Every collective is an exchange the
    engine counted, and a rank skips a ragged pass, a prefill or a replay
    group only where it holds no row of it."""
    _, _, got = runs
    for rank in (0, 1):
        r = got[rank]["tree"]
        ex, c = r["exchanges"], r["counters"]
        assert r["gathers"] == sum(ex.values())
        # a tree pass that a submit rewound (abort_step) is never read back
        assert ex["draft"] == c["draft_calls"] and ex["target"] == c["commit_calls"] < c["target_calls"]
        assert 0 < ex["admit"] <= len(r["outs"]) and ex["peek"] == ex["failure"] == ex["commit"] == 0
        idle = r["idle"]
        assert idle["replay"] == 0 and idle["ragged"] < c["ragged_calls"]
    assert sum(got[r]["tree"]["idle"]["prefill"] for r in (0, 1)) == len(got[0]["tree"]["outs"])
    for rank in (0, 1):
        r = got[rank]["replay"]
        ex, c, steps = r["exchanges"], r["counters"], r["counters"]["commit_calls"]
        assert r["gathers"] == sum(ex.values())
        assert ex["target"] == ex["commit"] == steps
        assert ex["draft"] == steps * (1 + REPLAY_ECFG["L1"] + REPLAY_ECFG["L2"])
        assert ex["draft"] < c["draft_calls"]  # a recurrent draft's ingest: one exchange for its groups


def test_mesh_form_refusals(runs):
    _, _, got = runs
    for rank in (0, 1):
        ref = got[rank]["refusals"]
        assert ref["n_slots"].startswith("ValueError") and "pad_slots" in ref["n_slots"]
        assert ref["model axis"].startswith("NotImplementedError") and "item 18" in ref["model axis"]


@pytest.mark.parametrize("where", ["ingest", "tree"])
def test_a_failing_rank_fails_every_rank(runs, where):
    """Rank 1 raises in the draft ingest (a pass whose readback is an
    exchange: it joins it with its error) or in the tree pass's dispatch
    (outside every exchange: it announces the error in one "failure"
    exchange); both ranks raise, and neither waits."""
    _, _, got = runs
    msg0, ex0 = got[0]["failures"][where]
    msg1, ex1 = got[1]["failures"][where]
    assert f"the {where} pass failed on purpose" in msg1
    assert "rank 1 failed" in msg0 and f"the {where} pass failed on purpose" in msg0
    assert ex1["failure"] == (where == "tree") and ex0["failure"] == 0
