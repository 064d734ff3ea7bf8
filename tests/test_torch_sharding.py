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
  * ``repro_torch.launch.serve --data-shards 2`` prints the tokens of
    ``--data-shards 1``.

The port's own properties (sharded == unsharded, the JAX property suite's
mirrors, the commit counters, the race harness) are in
tests/test_torch_sharding_props.py, which shares this module's models.
"""
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

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


# per family, one jit cache for every JAX engine and shard of this module:
# every compiled function is keyed by its config and shapes, so a case reuses
# what an earlier case compiled instead of recompiling it
JAX_JIT: dict = {}


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
    assert len(shard_meshes(3, "cpu")) == 3
    with pytest.raises(NotImplementedError, match="8c"):  # one pool over several devices
        pool_shardings(["cpu", "cpu"], init_cache(TConfig(**DENSE_T), 2, 32, "cpu", True))
    with pytest.raises(ValueError, match="--distributed"):  # a shard away from its weights
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
        if side == "jax":
            eng._jit_cache = JAX_JIT.setdefault(fam, {})
            for sh in eng.shards:
                sh._jit_cache = eng._jit_cache
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
