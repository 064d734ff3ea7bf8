"""examples/serve_speculative.py's own models through both engines, on the CPU.

The example serves a target with 6/2 heads of 32 and a draft with 2/1 heads
of 48.  The tree kernels compile instances at both head_dims (their
wrappers' ``_HEAD_DIMS``), and on the CPU the port's ``SpeculativeEngine``
serves the example's two ``ModelConfig``s token for token as the JAX one
does, from the same weights (bridged) and seeds: specinfer at (2, 2, 2),
temperature 0.9, ``max_cache`` 512, seed 0.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np

from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init_params
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.kernels import paged_tree_attention, tree_attention
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import engine as teng

V = 256  # examples/serve_speculative.py
TARGET = dict(name="target", n_layers=4, d_model=192, n_heads=6, n_kv_heads=2, d_ff=384, vocab=V, dtype="float32")
DRAFT = dict(name="draft", n_layers=1, d_model=96, n_heads=2, n_kv_heads=1, d_ff=192, vocab=V, dtype="float32")


def test_the_tree_kernels_compile_the_example_s_head_dims():
    assert tree_attention._HEAD_DIMS == (32, 48, 64, 128, 256)
    assert paged_tree_attention._HEAD_DIMS == (32, 48, 64, 128, 256)
    assert (TConfig(**TARGET).hd, TConfig(**DRAFT).hd) == (32, 48)
    assert (JConfig(**TARGET).hd, JConfig(**DRAFT).hd) == (32, 48)


def test_engines_serve_the_example_s_models_token_for_token():
    jt, jd = JConfig(**TARGET), JConfig(**DRAFT)
    jtp, jdp = j_init_params(jt, jax.random.PRNGKey(0)), j_init_params(jd, jax.random.PRNGKey(1))

    def to_t(p):
        return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, 12).tolist() for _ in range(2)]
    outs = []
    for mod, args in ((jeng, (jt, jtp, jd, jdp)), (teng, (TConfig(**TARGET), to_t(jtp), TConfig(**DRAFT), to_t(jdp)))):
        eng = mod.SpeculativeEngine(*args, mod.EngineConfig(verifier="specinfer", K=2, L1=2, L2=2, max_cache=512,
                                                            seed=0), mod.SamplingParams(0.9, 1.0))
        outs.append(([eng.generate(p, max_new=24) for p in prompts], dict(eng.counters)))
    assert outs[1] == outs[0]
    assert all(len(t) == 24 for t in outs[0][0]) and outs[0][1]["target_calls"] > 0
