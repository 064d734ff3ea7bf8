"""The PyTorch port's speculative engine against the JAX package, on the CPU.

  * token identity: from the same weights (bridged) and seeds, the port's
    ``SpeculativeEngine`` emits exactly the JAX engine's tokens and counts;
  * the copied host core: every registry verifier returns the same
    (accepted, correction) as ``repro.core.verify`` on random trees with the
    same rng;
  * the import rule: nothing under src/repro_torch/ nor chip_smoke.py
    imports ``jax`` or ``repro``;
  * the device rule: the serving CLI defaults to cuda and raises without it.
"""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

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
        toks = [eng.generate([5, 1, 7, 2], max_new=10), eng.generate([9, 4, 3, 8], max_new=8)]
        outs.append((toks, dict(eng.counters)))
    assert outs[1] == outs[0]
    assert outs[0][1]["accepted"] > 0  # some drafts were accepted, so commits moved KV


def test_engine_refuses_what_is_not_ported(models):
    _, (tt, ttp, td, tdp) = models
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        teng.SpeculativeEngine(tt, ttp, td, tdp, teng.EngineConfig(verify_on_device=True))
    with pytest.raises(NotImplementedError, match="replay"):
        teng.SpeculativeEngine(tt.replace(arch_type="ssm"), ttp, td, tdp, teng.EngineConfig())


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


def test_cli_streams_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tserve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--streams", "2"])


def test_cli_cpu_smoke_runs_end_to_end(capsys):
    tserve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--requests", "1",
                 "--max-new", "6", "--verifier", "traversal"])
    out = capsys.readouterr().out
    assert "req0: [" in out and "tokens/s(cpu)=" in out
