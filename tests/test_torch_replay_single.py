"""The port's single-stream engine on the replay strategy against the JAX
package, on the CPU.

The configs and weights of tests/test_torch_replay.py (the small SSM and
hybrid configs of tests/test_batch_engine.py in float32, target and draft
from two keys, bridged from JAX): ``SpeculativeEngine`` emits the JAX
engine's tokens and counters for specinfer, traversal and greedy_mpbv, over
two requests at (K, L1, L2) = (2, 1, 1).  The JAX engines of one family
share one jit cache, so each shape compiles once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax

from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init_params
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import engine as teng

V = 32
KW = {
    "ssm": dict(name="s", arch_type="ssm", n_layers=2, d_model=48, vocab=V, ssm_state=16, ssm_headdim=16,
                ssm_chunk=8, dtype="float32"),
    "hybrid": dict(name="h", arch_type="hybrid", n_layers=5, d_model=48, n_heads=4, n_kv_heads=1, d_ff=96,
                   vocab=V, local_window=32, dtype="float32"),
}
PROMPTS = [[5, 1, 7, 2], [9, 4, 6, 3]]
MAX_NEW = [8, 5]
ACTION = (2, 1, 1)


@pytest.fixture(scope="module", params=list(KW))
def family(request):
    kw = KW[request.param]
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    init = jax.jit(j_init_params, static_argnums=0)
    jtp, jdp = init(jcfg, jax.random.PRNGKey(0)), init(jcfg, jax.random.PRNGKey(1))

    def to_t(p):
        return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)

    return {"jax": (jcfg, jtp, jcfg, jdp), "torch": (tcfg, to_t(jtp), tcfg, to_t(jdp)), "jit": {}}


@pytest.mark.parametrize("verifier", ["specinfer", "traversal", "greedy_mpbv"])
def test_single_stream_matches_jax(family, verifier):
    outs = []
    for mod, args in ((jeng, family["jax"]), (teng, family["torch"])):
        eng = mod.SpeculativeEngine(*args, mod.EngineConfig(verifier, *ACTION, max_cache=64, seed=3))
        if mod is jeng:
            eng._jit_cache = family["jit"]
        assert eng.strategy == "replay"
        toks = [eng.generate(list(p), max_new=m) for p, m in zip(PROMPTS, MAX_NEW)]
        outs.append((toks, dict(eng.counters)))
    assert outs[1] == outs[0]
    assert outs[0][1]["accepted"] > 0
