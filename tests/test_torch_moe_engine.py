"""The port's engines on MoE models against the JAX package, on the CPU, in
float32, from the same weights (bridged from JAX) and seeds:

  * ``SpeculativeEngine`` is token- and counter-identical to JAX's with the
    qwen3-moe smoke and its ``make_draft_cfg`` draft (specinfer, traversal);
  * ``BatchedSpeculativeEngine`` (paged, ragged auto, pipelined) is token-
    and counter-identical to JAX's for the flat qwen3-moe target and an
    interleaved llama4-maverick target (2 groups), both pools equal after
    every step (KV on admitted lanes to atol 1e-4).  ``make_draft_cfg`` of
    the llama4 smoke is one layer with moe_every 2, which JAX's init_params
    rejects, so the interleaved target takes the qwen3-moe smoke's draft
    (vocab 512 both).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np

from repro.configs import llama4_maverick_400b_a17b as jllama4
from repro.configs import qwen3_moe_235b_a22b as jqwen3
from repro.launch.serve import make_draft_cfg as j_make_draft_cfg
from repro.models import cache as jc
from repro.models import transformer as jt
from repro.serving import batch_engine as jbe
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.launch.serve import make_draft_cfg
from repro_torch.models import cache as tc
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import batch_engine as tbe
from repro_torch.serving import engine as teng

ATOL = 1e-4
FLAT = jqwen3.smoke().replace(dtype="float32")
INTERLEAVED = jllama4.smoke().replace(dtype="float32", n_layers=4)  # 2 groups of (dense, moe)


def to_torch_cfg(jcfg) -> TConfig:
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})


def _to_t(p):
    return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def pairs():
    """(JAX models, port models) for the flat target with its own draft and
    the interleaved target with the flat target's draft."""
    jdraft = j_make_draft_cfg(FLAT)
    assert to_torch_cfg(jdraft) == make_draft_cfg(to_torch_cfg(FLAT))
    jdp = jt.init_params(jdraft, jax.random.PRNGKey(1))
    out = {}
    for name, jtgt in (("flat", FLAT), ("interleaved", INTERLEAVED)):
        jtp = jt.init_params(jtgt, jax.random.PRNGKey(0))
        out[name] = ((jtgt, jtp, jdraft, jdp),
                     (to_torch_cfg(jtgt), _to_t(jtp), to_torch_cfg(jdraft), _to_t(jdp)))
    return out


JAX_JIT: dict = {}  # the JAX single-stream engines' shared jit cache


@pytest.mark.parametrize("verifier", ["specinfer", "traversal"])
def test_engine_token_identity(pairs, verifier):
    outs = []
    for mod, args in zip((jeng, teng), pairs["flat"]):
        ecfg = mod.EngineConfig(verifier=verifier, K=2, L1=1, L2=2, max_cache=64, seed=3)
        eng = mod.SpeculativeEngine(*args, ecfg, mod.SamplingParams(0.8, 0.9))
        if mod is jeng:  # one jit cache for the cases: compiled functions are keyed by config and shapes
            eng._jit_cache = JAX_JIT
        toks = eng.generate([5, 1, 7, 2], max_new=8)
        outs.append((toks, dict(eng.counters)))
    assert outs[1] == outs[0]
    assert outs[0][1]["accepted"] > 0


def _same_pools(jeng_, teng_):
    for jp, tp in ((jeng_.tpool, teng_.tpool), (jeng_.dpool, teng_.dpool)):
        assert tp._free == jp._free
        np.testing.assert_array_equal(tp._tbl, jp._tbl)
        assert tp._free_blocks == jp._free_blocks
        rows = range(jp.n_slots)
        jv, tv = jc.gather_streams(jp.cache, rows)["attn"], tc.gather_streams(tp.cache, rows)["attn"]
        jpos = np.asarray(jv["pos"])
        np.testing.assert_array_equal(tv["pos"].numpy(), jpos)
        np.testing.assert_array_equal(tv["len"].numpy(), np.asarray(jv["len"]))
        live = (jpos >= 0) & np.isin(np.arange(jp.n_slots), sorted(jeng_.streams))[:, None]
        for name in ("k", "v"):
            np.testing.assert_allclose(tv[name].numpy()[:, live], np.asarray(jv[name])[:, live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("target", ["flat", "interleaved"])
def test_batched_engine_matches_jax(pairs, target):
    """Paged pool, ragged auto, pipelined; 3 requests over 2 rows (admission
    queues, drain tails go ragged)."""
    prompts, max_new, seeds = [[5, 1, 7, 2], [9, 4], [3, 8, 8, 1, 6]], [6, 3, 7], [20, 21, 22]
    engs = [mod.BatchedSpeculativeEngine(*args, emod.EngineConfig("specinfer", 2, 1, 2, max_cache=64), n_slots=2,
                                         paged=True, block_size=8, pipeline=True, ragged=True)
            for mod, emod, args in ((jbe, jeng, pairs[target][0]), (tbe, teng, pairs[target][1]))]
    rids = [[e.submit(list(p), max_new=m, seed=s) for p, m, s in zip(prompts, max_new, seeds)] for e in engs]
    while engs[0].queue or engs[0].streams:
        for e in engs:
            e.step()
        _same_pools(*engs)
    assert not (engs[1].queue or engs[1].streams)
    want, got = ([(e.finished[r]["tokens"], e.finished[r]["reason"]) for r in rs] for e, rs in zip(engs, rids))
    assert got == want
    wc = {k: v for k, v in engs[0].counters.items() if k != "commit_ms"}
    c = engs[1].counters
    assert {k: c[k] for k in wc} == wc
    assert c["accepted"] > 0 and c["ragged_calls"] > 0 and c["padded_calls"] > 0
    assert c["pipeline_ahead"] > 0
