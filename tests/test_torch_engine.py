"""The PyTorch port's speculative engine against the JAX package, on the CPU.

  * token identity: from the same weights (bridged) and seeds, the port's
    ``SpeculativeEngine`` emits exactly the JAX engine's tokens and counts,
    also on the minitron-8b and qwen2-72b smokes with their drafts;
  * the copied host core: every registry verifier returns the same
    (accepted, correction) as ``repro.core.verify`` on random trees with the
    same rng;
  * the import rule: nothing under src/repro_torch/ nor chip_smoke.py
    imports ``jax`` or ``repro``;
  * the device rule: the serving CLI defaults to cuda and raises without it;
  * the CLI serves ``--streams`` through the batched engine on the CPU.
"""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np

from repro.core import trees as jtrees
from repro.core import verify as jverify
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init_params
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.core import trees as ttrees
from repro_torch.core import verify as tverify
from repro_torch.launch import serve as tserve
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import engine as teng

ROOT = Path(__file__).resolve().parents[1]
V = 32


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


JAX_JIT: dict = {}  # the JAX engines' shared jit cache (test_engine_token_identity)


@pytest.mark.parametrize("verifier,K,L1,L2,temperature,top_p", [
    ("specinfer", 2, 1, 2, 0.8, 0.9),
    ("traversal", 2, 2, 1, 1.0, 1.0),
    ("bv", 1, 1, 2, 1.0, 1.0),
])
def test_engine_token_identity(models, verifier, K, L1, L2, temperature, top_p):
    (jt, jtp, jd, jdp), (tt, ttp, td, tdp) = models
    sampling = dict(temperature=temperature, top_p=top_p)
    outs = []
    for mod, args in ((jeng, (jt, jtp, jd, jdp)), (teng, (tt, ttp, td, tdp))):
        ecfg = mod.EngineConfig(verifier=verifier, K=K, L1=L1, L2=L2, max_cache=64, seed=3)
        eng = mod.SpeculativeEngine(*args, ecfg, mod.SamplingParams(**sampling))
        if mod is jeng:  # one jit cache for the cases: compiled functions are keyed by config and shapes
            eng._jit_cache = JAX_JIT
        toks = [eng.generate([5, 1, 7, 2], max_new=10), eng.generate([9, 4, 3, 8], max_new=8)]
        outs.append((toks, dict(eng.counters)))
    assert outs[1] == outs[0]
    assert outs[0][1]["accepted"] > 0  # some drafts were accepted, so commits moved KV


@pytest.mark.parametrize("arch", ["minitron-8b", "qwen2-72b"])
def test_dense_config_smokes_token_identity(arch):
    """The two dense configs of this slice (qwen2-72b with its QKV bias):
    their float32 smokes and make_draft_cfg drafts, bridged from JAX, give
    the JAX engine's tokens and counts."""
    from repro.configs import get_smoke as j_get_smoke
    from repro.launch.serve import make_draft_cfg as j_make_draft_cfg
    from repro_torch.configs import get_smoke as t_get_smoke
    from repro_torch.launch.serve import make_draft_cfg as t_make_draft_cfg

    jt, tt = j_get_smoke(arch).replace(dtype="float32"), t_get_smoke(arch).replace(dtype="float32")
    jd, td = j_make_draft_cfg(jt), t_make_draft_cfg(tt)
    init = jax.jit(j_init_params, static_argnums=0)
    jtp, jdp = init(jt, jax.random.PRNGKey(0)), init(jd, jax.random.PRNGKey(1))
    outs = []
    for mod, args in ((jeng, (jt, jtp, jd, jdp)), (teng, (tt, bridge.params_from_jax(jax.tree.map(np.asarray, jtp),
                                                                                   device="cpu"),
                                                          td, bridge.params_from_jax(jax.tree.map(np.asarray, jdp),
                                                                                     device="cpu")))):
        eng = mod.SpeculativeEngine(*args, mod.EngineConfig("specinfer", 2, 1, 2, max_cache=64, seed=4))
        outs.append((eng.generate([5, 1, 7, 2], max_new=10), dict(eng.counters)))
    assert outs[1] == outs[0]


def test_engine_refuses_what_is_not_ported(models):
    _, (tt, ttp, td, tdp) = models
    # on-device verification is ported (tests/test_torch_otlp_device.py): it builds
    eng = teng.SpeculativeEngine(tt, ttp, td, tdp, teng.EngineConfig(verify_on_device=True))
    assert eng.ecfg.verify_on_device and eng.ecfg.verifier in teng.TOPDOWN
    # an unknown family raises ValueError, as in JAX
    with pytest.raises(ValueError, match="conv"):
        teng.SpeculativeEngine(tt.replace(arch_type="conv"), ttp, td, tdp, teng.EngineConfig()).new_stream([1, 2])
    # the encoder-decoder family is ported: a whisper smoke pair builds and prefills
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_params

    wt = get_smoke("whisper-medium").replace(dtype="float32")
    wd = tserve.make_draft_cfg(wt)
    eng = teng.SpeculativeEngine(wt, init_params(wt, torch.Generator().manual_seed(0)), wd,
                                 init_params(wd, torch.Generator().manual_seed(1)), teng.EngineConfig(max_cache=64))
    stream = eng.new_stream([1, 2, 3], enc_embeds=torch.randn(1, wt.enc_len, wt.d_model))
    assert int(stream["tcache"]["attn"]["len"]) == 2 and stream["tcache"]["cross_k"].abs().max() > 0


def _random_tree(rng, K, L1, L2, vocab=6):
    def dist(_ctx):
        return rng.dirichlet(np.full(vocab, 0.5))

    tree = jtrees.build_delayed_tree(rng, dist, K, L1, L2)
    jtrees.attach_target(tree, dist)
    return tree


def test_registry_verifiers_match_jax_core():
    assert tverify.verifier_names() == jverify.verifier_names()
    assert len(tverify.VERIFIERS) == 11
    for name in tverify.verifier_names():
        assert tverify.VERIFIERS[name].multipath == jverify.VERIFIERS[name].multipath
        assert tverify.VERIFIERS[name].on_device == jverify.VERIFIERS[name].on_device
    rng = np.random.default_rng(0)
    for trial in range(12):
        for name in tverify.verifier_names():
            multipath = tverify.VERIFIERS[name].multipath
            shape = (int(rng.integers(2, 4)), int(rng.integers(0, 3)), int(rng.integers(1, 3))) \
                if multipath else (1, int(rng.integers(0, 3)), int(rng.integers(1, 3)))
            jtree = _random_tree(rng, *shape)
            ttree = ttrees.DraftTree(**{f.name: getattr(jtree, f.name)
                                        for f in dataclasses.fields(ttrees.DraftTree)})
            seed = int(rng.integers(2**31))
            got = tverify.get_verifier(name).verify(ttree, np.random.default_rng(seed))
            want = jverify.get_verifier(name).verify(jtree, np.random.default_rng(seed))
            assert got == want, (name, trial)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_cli_defaults_to_cuda_and_raises_without_it():
    assert tserve.build_parser().parse_args(["--arch", "granite-8b"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "granite-8b", "--smoke"])


def test_cli_streams_serves_end_to_end(capsys):
    tserve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--streams", "2", "--requests", "3",
                 "--max-new", "6"])
    out = capsys.readouterr().out
    assert all(f"req{r}: [" in out for r in range(3))
    assert "[batched x2]" in out and "paged(block=64" in out and "pipelined(" in out
    assert "host ms/step (" in out and " verify=" in out and "readback used=" in out
    # --data-shards is ported (tests/test_torch_sharding.py): it serves
    tserve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--streams", "2", "--data-shards", "2",
                 "--requests", "2", "--max-new", "4"])
    assert "shards=2(x1 slots" in capsys.readouterr().out


def test_cli_cpu_smoke_runs_end_to_end(capsys):
    tserve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--requests", "1",
                 "--max-new", "6", "--verifier", "traversal"])
    out = capsys.readouterr().out
    assert "req0: [" in out and "tokens/s(cpu)=" in out
