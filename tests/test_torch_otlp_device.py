"""The port's on-device top-down OT verification against the JAX package and
the numpy oracles, on the CPU.

  * the solvers' deterministic parts (SpecTr's rho, the two-stage
    importance law, every solver's residual) within 1e-6 of
    ``repro.core.otlp_jax`` in float32 on seeded Dirichlet p, q;
  * each solver's law against the numpy oracle's ``output_dist`` (atol 0.04
    at 4000 draws, as tests/test_otlp_jax.py holds the JAX solvers), with
    padded candidate slots behaving as a smaller k;
  * the tree walk's block law against ``verify_topdown_output_dist`` (worst
    block < 0.05 at 5000 draws), and the batched shapes;
  * ``sample_categorical``: never a zero-probability token, and its law;
  * ``SpeculativeEngine(verify_on_device=True)`` serves on the dense and the
    ssm smokes with one host rng draw per verification, as the JAX engine
    does, and a non-top-down verifier stays on the host path; the launcher's
    ``--verify-on-device`` serves, and the batched engines refuse it.

torch cannot reproduce ``jax.random``, so the random parts are held by law,
not draw for draw.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import otlp_jax
from repro.core.enumerate import RandomModel
from repro.core.otlp import OTLP_SOLVERS
from repro.core.trees import attach_target, build_delayed_tree
from repro.core.verify import verify_topdown_output_dist
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init_params
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.core import otlp_device as od
from repro_torch.launch import serve as tserve
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.sampling import sample_categorical
from repro_torch.serving import engine as teng

V = 6
SEEDS = [0, 3, 7, 11]


def _pq(seed):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(V)), rng.dirichlet(np.ones(V))


def _t(a, n=1):
    return torch.tensor(np.asarray(a), dtype=torch.float32)[None].repeat(n, 1)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ----------------------------------------------------- deterministic parts ---


@pytest.mark.parametrize("k", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_spectr_rho_and_khisti_importance_match_jax(seed, k):
    p, q = _pq(seed)
    jp, jq = jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32)
    kt = torch.tensor([k])
    _close(od._spectr_rho(_t(p), _t(q), kt)[0], otlp_jax._spectr_rho(jp, jq, jnp.asarray(k)))
    _close(od.khisti_importance(_t(p), _t(q), kt)[0], otlp_jax.khisti_importance(jp, jq, jnp.asarray(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_solver_residuals_match_jax(seed):
    """naive's (p - q)+, SpecTr's p - gamma min(p / rho, q), the two-stage
    (p - r)+, and two rejection steps of SpecInfer's chain."""
    p, q = _pq(seed)
    jp, jq = jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32)
    tp, tq = _t(p), _t(q)
    _close(od.naive_residual(tp, tq)[0], otlp_jax._norm(otlp_jax._pos(jp - jq)))
    for k in (1.0, 2.0, 4.0):
        rho = otlp_jax._spectr_rho(jp, jq, jnp.asarray(k))
        cap = jnp.minimum(jp / rho, jq)
        beta = jnp.sum(cap)
        gamma = jnp.where(beta > 0, (1.0 - (1.0 - beta) ** k) / jnp.maximum(beta, 1e-30), 0.0)
        t_rho, t_res = od.spectr_residual(tp, tq, torch.tensor([k]))
        _close(t_rho[0], rho)
        _close(t_res[0], otlp_jax._norm(otlp_jax._pos(jp - cap * gamma)))
        jr = otlp_jax.khisti_importance(jp, jq, jnp.asarray(k))
        _close(od.naive_residual(tp, od.khisti_importance(tp, tq, torch.tensor([k])))[0],
               otlp_jax._norm(otlp_jax._pos(jp - jr)))
    jcur, tcur = otlp_jax._norm(jp), od._norm(tp)
    for _ in range(2):
        jcur, tcur = otlp_jax._norm(otlp_jax._pos(jcur - jq)), od.naive_residual(tcur, tq)
        _close(tcur[0], jcur)


# ------------------------------------------------------------------ laws ---


def _freq(ys: torch.Tensor) -> np.ndarray:
    return np.bincount(ys.numpy(), minlength=V) / len(ys)


@pytest.mark.parametrize("xs", [[1, 4], [0, 5]], ids=["xs14", "xs05"])
@pytest.mark.parametrize("solver", ["nss", "naive", "spectr", "specinfer", "khisti"])
def test_solver_matches_oracle_distribution(solver, xs):
    p, q = _pq(3)
    want = OTLP_SOLVERS[solver][1](p, q, xs)
    n = 4000
    gen = torch.Generator().manual_seed(0)
    ys = od.SOLVERS_DEVICE[solver](_t(p, n), _t(q, n), torch.tensor([xs]).repeat(n, 1),
                                   torch.ones((n, 2), dtype=torch.bool), gen)
    assert ys.shape == (n,)
    np.testing.assert_allclose(_freq(ys), want, atol=0.04)


@pytest.mark.parametrize("solver", ["spectr", "specinfer", "khisti"])
def test_solver_respects_valid_mask(solver):
    """Padded (invalid) slots behave exactly as a smaller k."""
    p, q = _pq(7)
    want = OTLP_SOLVERS[solver][1](p, q, [2])
    n = 4000
    valid = torch.tensor([[True, False, False, False]]).repeat(n, 1)
    ys = od.SOLVERS_DEVICE[solver](_t(p, n), _t(q, n), torch.tensor([[2, 0, 0, 0]]).repeat(n, 1), valid,
                                   torch.Generator().manual_seed(1))
    np.testing.assert_allclose(_freq(ys), want, atol=0.04)


def test_sample_categorical_law_and_zeros():
    probs = np.asarray([0.0, 0.5, 0.0, 0.2, 0.3, 0.0])
    n = 4000
    ys = sample_categorical(_t(probs, n), torch.Generator().manual_seed(2))
    assert ys.dtype == torch.int64 and ys.shape == (n,)
    assert not np.isin(ys.numpy(), np.flatnonzero(probs == 0)).any()
    np.testing.assert_allclose(_freq(ys), probs, atol=0.04)
    tiny = np.full(V, 1e-35)
    tiny[3] = 0.0
    ys = sample_categorical(_t(tiny, n), torch.Generator().manual_seed(3))
    assert not (ys == 3).any(), "a zero-probability token among tiny ones"


def _tree_arrays(tree, max_nodes):
    N = tree.n_nodes
    tokens = np.full(max_nodes, -1, np.int64)
    parent = np.full(max_nodes, -1, np.int64)
    tokens[:N], parent[:N] = tree.tokens, tree.parent
    p = np.zeros((max_nodes, tree.vocab), np.float32)
    q = np.zeros((max_nodes, tree.vocab), np.float32)
    p[:N], q[:N] = tree.p, tree.q
    return [torch.as_tensor(a) for a in (tokens, parent, p, q)]


@pytest.mark.parametrize("solver", ["specinfer", "spectr", "naivetree"])
def test_tree_verify_matches_host_block_distribution(solver):
    model = RandomModel(4, seed=5, divergence=0.6)
    tree = attach_target(build_delayed_tree(np.random.default_rng(0), model.q, 2, 1, 1), model.p)
    want = verify_topdown_output_dist(tree, solver)  # the exact conditional law
    n = 5000
    arrs = [a[None].expand((n,) + a.shape) for a in _tree_arrays(tree, 8)]
    out_tok, n_acc, corr = od.verify_topdown_batched(*arrs, torch.Generator().manual_seed(2), solver=solver,
                                                     max_depth=4, max_children=4)
    got: dict = {}
    for row, k, c in zip(out_tok.tolist(), n_acc.tolist(), corr.tolist()):
        blk = tuple(row[:k]) + (c,)
        got[blk] = got.get(blk, 0) + 1.0 / n
    worst = max(abs(want.get(k, 0) - got.get(k, 0)) for k in set(want) | set(got))
    assert worst < 0.05, worst
    # the one-tree form walks the same law: its block is one the law allows
    out1, n1, c1 = od.verify_topdown(*_tree_arrays(tree, 8), torch.Generator().manual_seed(3), solver=solver,
                                     max_depth=4, max_children=4)
    assert out1.shape == (4,) and (tuple(out1[:int(n1)].tolist()) + (int(c1),)) in want


def test_tree_verify_batched_shapes():
    model = RandomModel(4, seed=9, divergence=0.5)
    rng = np.random.default_rng(1)
    B = 3
    trees = [attach_target(build_delayed_tree(rng, model.q, 2, 1, 1), model.p) for _ in range(B)]
    arrs = [torch.stack(col) for col in zip(*(_tree_arrays(t, 8) for t in trees))]
    out_tok, n_acc, corr = od.verify_topdown_batched(*arrs, torch.Generator().manual_seed(3), max_depth=4)
    assert out_tok.shape == (B, 4) and n_acc.shape == (B,) and corr.shape == (B,)
    assert bool((corr >= 0).all()) and bool((n_acc <= 3).all())
    assert all((row[int(k):] == -1).all() for row, k in zip(out_tok, n_acc))


# --------------------------------------------------------------- engines ---


class CountingRng:
    """A numpy Generator that counts its ``integers`` draws."""

    def __init__(self, rng):
        self._rng, self.integer_draws = rng, 0

    def integers(self, *a, **kw):
        self.integer_draws += 1
        return self._rng.integers(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._rng, name)


SMOKES = {
    "dense": (dict(name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=32),
              dict(name="d", arch_type="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=96, vocab=32)),
    "ssm": (dict(name="s", arch_type="ssm", n_layers=2, d_model=48, vocab=32, ssm_state=16, ssm_headdim=16,
                 ssm_chunk=8),) * 2,
}


@pytest.fixture(scope="module", params=list(SMOKES))
def smoke(request):
    tkw, dkw = SMOKES[request.param]
    jt, jd = JConfig(dtype="float32", **tkw), JConfig(dtype="float32", **dkw)
    jtp, jdp = j_init_params(jt, jax.random.PRNGKey(0)), j_init_params(jd, jax.random.PRNGKey(1))

    def to_t(p):
        return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)

    return {"jax": (jt, jtp, jd, jdp),
            "torch": (TConfig(dtype="float32", **tkw), to_t(jtp), TConfig(dtype="float32", **dkw), to_t(jdp))}


@pytest.mark.parametrize("verifier", ["specinfer", "spectr"])
def test_engine_verifies_on_device_with_jax_rng_use(smoke, verifier):
    """One host rng draw per verification in both engines (the JAX engine
    draws its key there); the tokens then come from each framework's own
    random stream, so they are checked for range and count only."""
    draws = []
    for mod, args in ((jeng, smoke["jax"]), (teng, smoke["torch"])):
        eng = mod.SpeculativeEngine(*args, mod.EngineConfig(verifier, 2, 1, 1, max_cache=64, seed=5,
                                                            verify_on_device=True))
        eng.rng = CountingRng(eng.rng)
        out = eng.generate([5, 1, 7, 2], max_new=10)
        assert len(out) == 10 and all(0 <= t < 32 for t in out)
        assert eng.rng.integer_draws == eng.counters["blocks"] > 0
        draws.append(eng.rng.integer_draws)
    assert draws[1] > 0


def test_engine_non_topdown_verifier_stays_on_host(smoke):
    outs = []
    for on_device in (False, True):
        eng = teng.SpeculativeEngine(*smoke["torch"], teng.EngineConfig("traversal", 2, 1, 1, max_cache=64, seed=5,
                                                                         verify_on_device=on_device))
        eng.rng = CountingRng(eng.rng)
        outs.append((eng.generate([5, 1, 7, 2], max_new=10), dict(eng.counters)))
        assert eng.rng.integer_draws == 0
    assert outs[1] == outs[0]


def test_cli_verify_on_device(capsys):
    argv = ["--device", "cpu", "--smoke", "--arch", "granite-8b", "--verifier", "spectr", "--requests", "1",
            "--max-new", "6", "--verify-on-device"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert "req0: [" in out and "verifier=spectr on the device" in out
    with pytest.raises(ValueError, match="verifies per-stream on host"):
        tserve.main(argv + ["--streams", "2"])
