"""The port's selector stack against the JAX package, on the CPU in float32.

  * the copied host core: ``estimate_block_efficiency``,
    ``expected_block_efficiency(_dist)`` and ``analytic_best_action`` equal
    the JAX package's for every registry verifier with the same rng, and
    the port's ``enumerate.py`` gives the same lossless gap of delayed
    trees (numpy on both sides: exact);
  * ``init_selector`` draws the JAX module's shapes and distributions;
  * ``selector_logits`` on bridged params (abs 1e-5), the same argmax and
    ``select_action``;
  * ``selector_loss`` and its autograd gradient against ``jax.grad`` with
    dropout 0 (1e-5);
  * ``AdamW``: 20 steps with clipping, warmup and cosine decay (1e-6
    relative);
  * ``train_selector`` with dropout 0 from the bridged JAX init: the same
    losses over 30 steps (1e-4 relative);
  * ``collect_traces`` on the granite smoke pair with bridged weights: all
    six arrays (1e-4).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import delayed as jdelayed
from repro.core import enumerate as jenum
from repro.core import selector as jsel
from repro.core import verify as jverify
from repro.configs import get_smoke as j_get_smoke
from repro.launch.serve import make_draft_cfg as j_make_draft_cfg
from repro.models.transformer import init_params as j_init_params
from repro.serving import engine as jeng
from repro.training import optim as joptim
from repro.training import selector_train as jtrain
from repro_torch import bridge
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import delayed as tdelayed
from repro_torch.core import enumerate as tenum
from repro_torch.core import selector as tsel
from repro_torch.core import verify as tverify
from repro_torch.launch.serve import make_draft_cfg as t_make_draft_cfg
from repro_torch.serving import engine as teng
from repro_torch.training import optim as toptim
from repro_torch.training import selector_train as ttrain

ACTIONS = [(1, 3, 0), (2, 1, 1), (2, 2, 2), (4, 1, 1)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return toptim.tree_map(lambda a: torch.as_tensor(np.asarray(a, np.float32)), tree)


# ------------------------------------------------------------ host core ---


@pytest.mark.parametrize("verifier", tverify.verifier_names())
def test_estimators_match_jax(verifier):
    assert tverify.verifier_names() == jverify.verifier_names()
    jm, tm = jenum.RandomModel(4, seed=7, divergence=0.7), tenum.RandomModel(4, seed=7, divergence=0.7)
    # single-path verifiers take single-path trees (K = 1)
    multi = jverify.get_verifier(verifier).multipath
    shapes = [(2, 1, 1), (1, 2, 0), (3, 0, 2)] if multi else [(1, 1, 1), (1, 2, 0), (1, 0, 2)]
    for K, L1, L2 in shapes:
        want = jdelayed.estimate_block_efficiency(np.random.default_rng(3), jm.q, jm.p, verifier, K, L1, L2, s=3)
        got = tdelayed.estimate_block_efficiency(np.random.default_rng(3), tm.q, tm.p, verifier, K, L1, L2, s=3)
        assert got == want
        for (jt, _), (tt, _) in zip(list(jenum.iter_trees(jm, K, L1, L2))[:6],
                                    list(tenum.iter_trees(tm, K, L1, L2))[:6]):
            assert tdelayed.expected_block_efficiency_dist(tt, verifier) == \
                jdelayed.expected_block_efficiency_dist(jt, verifier)
            if jverify.get_verifier(verifier).on_device:
                assert tdelayed.expected_block_efficiency(tt, verifier) == \
                    jdelayed.expected_block_efficiency(jt, verifier)
    lat = (2e-4, 1e-7, 3e-3, 2e-7, 1e-5)
    kw = dict(K_max=2 if multi else 1, L1_max=2, L2_max=2)
    want = jdelayed.analytic_best_action(np.random.default_rng(5), jm.q, jm.p, verifier,
                                         jdelayed.LatencyModel(*lat), (1, 2), **kw)
    got = tdelayed.analytic_best_action(np.random.default_rng(5), tm.q, tm.p, verifier,
                                        tdelayed.LatencyModel(*lat), (1, 2), **kw)
    assert got == want


def test_latency_model_matches_jax():
    jl, tl = jdelayed.LatencyModel(1e-4, 1e-8, 1.2e-3, 1e-7, 3e-5), tdelayed.LatencyModel(1e-4, 1e-8, 1.2e-3, 1e-7, 3e-5)
    for ctx in (0, 17, 900):
        assert (tl.t_q(ctx), tl.t_p(ctx)) == (jl.t_q(ctx), jl.t_p(ctx))
        for a in ACTIONS + [(3, 0, 4)]:
            assert tl.action_time(ctx, *a) == jl.action_time(ctx, *a)


@pytest.mark.parametrize("verifier", ["specinfer", "traversal", "univer"])
@pytest.mark.parametrize("K,L1,L2", [(2, 1, 1), (2, 0, 2), (3, 2, 1)])
def test_lossless_gap_of_delayed_trees(verifier, K, L1, L2):
    jm, tm = jenum.RandomModel(3, seed=11, divergence=0.7), tenum.RandomModel(3, seed=11, divergence=0.7)
    jbd = jenum.expected_block_dist(jverify.get_verifier(verifier).output_dist, jm, K, L1, L2)
    tbd = tenum.expected_block_dist(tverify.get_verifier(verifier).output_dist, tm, K, L1, L2)
    assert tbd == jbd
    gap = tenum.lossless_gap(tbd, tm, L1 + L2 + 1)
    assert gap == jenum.lossless_gap(jbd, jm, L1 + L2 + 1)
    assert gap < 1e-12
    assert tenum.mean_block_len(tbd) == jenum.mean_block_len(jbd)


def test_action_spaces_match_jax():
    for space in [(4, 8, 8), (2, 3, 1), (1, 0, 2)]:
        assert tsel.ActionSpace(*space).actions() == jsel.ActionSpace(*space).actions()
    assert tsel.ActionSpace().n == jsel.ActionSpace().n
    assert tsel.FixedSpace(ACTIONS).actions() == ACTIONS and tsel.FixedSpace(ACTIONS).n == 4


# ------------------------------------------------------------- selector ---


def _cfgs(hp, hq, **kw):
    """The same selector config in both packages, over the action grid ACTIONS."""
    return (jsel.SelectorConfig(hidden_p=hp, hidden_q=hq, space=jsel.FixedSpace(ACTIONS), **kw),
            tsel.SelectorConfig(hidden_p=hp, hidden_q=hq, space=tsel.FixedSpace(ACTIONS), **kw))


def _features(B, hp, hq, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, hp)).astype(np.float32), rng.normal(size=(B, hq)).astype(np.float32),
            rng.normal(size=(B, hq)).astype(np.float32), rng.normal(size=(B, 11)).astype(np.float32)]


def test_init_selector_shapes_and_scale():
    jcfg, tcfg = _cfgs(256, 128)
    jp = _np(jsel.init_selector(jcfg, jax.random.PRNGKey(0)))
    tp = tsel.init_selector(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(tp) == set(jp) == set(tsel.LAYERS)
    for name, layer in tp.items():
        assert {k: tuple(v.shape) for k, v in layer.items()} == {k: v.shape for k, v in jp[name].items()}
        assert layer["w"].dtype == torch.float32 and not layer["b"].any()
        din = layer["w"].shape[0]
        # N(0, 1/din): the scaled weights' spread, on at least 128 draws
        assert abs(float(layer["w"].std()) * np.sqrt(din) - 1.0) < 0.15
    again = tsel.init_selector(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(again[n]["w"], tp[n]["w"]) for n in tp)


@pytest.mark.parametrize("hp,hq", [(64, 64), (256, 128)])
def test_selector_logits_match_jax(hp, hq):
    jcfg, tcfg = _cfgs(hp, hq)
    jp = jsel.init_selector(jcfg, jax.random.PRNGKey(hp))
    tp = bridge.selector_params_from_jax(_np(jp), device="cpu")
    feats = _features(16, hp, hq, seed=hq)
    want = np.asarray(jsel.selector_logits(jp, *map(jnp.asarray, feats)))
    got = tsel.selector_logits(tp, *map(torch.as_tensor, feats)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for b in range(16):
        one = [f[b:b + 1] for f in feats]
        assert tsel.select_action(tp, *map(torch.as_tensor, one), tcfg.space) == \
            jsel.select_action(jp, *map(jnp.asarray, one), jcfg.space)


def test_selector_dropout_is_inverted_and_seeded():
    _, tcfg = _cfgs(64, 64)
    tp = tsel.init_selector(tcfg, torch.Generator().manual_seed(1), "cpu")
    feats = list(map(torch.as_tensor, _features(64, 64, 64, seed=2)))
    a = tsel.selector_logits(tp, *feats, generator=torch.Generator().manual_seed(3), dropout=0.5)
    b = tsel.selector_logits(tp, *feats, generator=torch.Generator().manual_seed(3), dropout=0.5)
    plain = tsel.selector_logits(tp, *feats)
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    assert torch.equal(tsel.selector_logits(tp, *feats, generator=None, dropout=0.5), plain)


def _trace_batch(B, hp, hq, A, seed):
    rng = np.random.default_rng(seed)
    h1, h2, h3, sc = _features(B, hp, hq, seed)
    return {"h_prev_p": h1, "h_prev_q": h2, "h_cur_q": h3, "scalars": sc,
            "eff": rng.uniform(1.0, 4.0, size=(B, A)).astype(np.float32),
            "time": rng.uniform(1e-3, 5e-3, size=(B, A)).astype(np.float32),
            "base": np.full(B, 1, np.int32)}


@pytest.mark.parametrize("kw", [{}, {"lam": 0.3, "cvar_alpha": 0.5, "aux_ce": 0.0}])
def test_selector_loss_and_grad_match_jax(kw):
    jcfg, _ = _cfgs(64, 64)
    jp = jsel.init_selector(jcfg, jax.random.PRNGKey(4))
    batch = _trace_batch(24, 64, 64, len(ACTIONS), seed=5)
    want, jg = jax.value_and_grad(lambda p: jsel.selector_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                                               **kw))(jp)
    tp = toptim.tree_map(lambda p: p.requires_grad_(True), bridge.selector_params_from_jax(_np(jp), "cpu"))
    got = tsel.selector_loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, **kw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    for name in tsel.LAYERS:
        for k in ("w", "b"):
            np.testing.assert_allclose(tp[name][k].grad.numpy(), np.asarray(jg[name][k]), atol=1e-5, rtol=0)


def test_adamw_matches_jax():
    rng = np.random.default_rng(6)
    params = {"a": {"w": rng.normal(size=(8, 5)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)},
              "c": rng.normal(size=(3,)).astype(np.float32)}
    kw = dict(lr=3e-2, weight_decay=0.05, clip_norm=0.5, warmup_steps=4, total_steps=20)
    jopt, topt = joptim.AdamW(**kw), toptim.AdamW(**kw)
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(20):
        # gradients large enough that clipping acts on some steps
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * (3.0 if i % 3 else 0.1), params)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(_t(g), ts, tp)
        assert ts.step == int(js.step)
    for a, b in zip(toptim.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for step in range(0, 22):
        assert float(topt.schedule(step, "cpu")) == pytest.approx(float(jopt.schedule(jnp.int32(step))), rel=1e-6)


def test_train_selector_matches_jax(monkeypatch):
    jcfg, tcfg = _cfgs(64, 32, dropout=0.0)
    traces = _trace_batch(40, 64, 32, len(ACTIONS), seed=8)
    del traces["base"]
    jparams, jlosses = jtrain.train_selector(traces, jcfg, steps=30, batch=16, lam=0.3, seed=2)
    # the port draws its init from a torch.Generator: start it from the JAX init instead
    j_init = _np(jsel.init_selector(jcfg, jax.random.PRNGKey(2)))
    monkeypatch.setattr(ttrain, "init_selector", lambda cfg, gen, device: bridge.selector_params_from_jax(j_init, device))
    tparams, tlosses = ttrain.train_selector(traces, tcfg, steps=30, batch=16, lam=0.3, seed=2, device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    for name in tsel.LAYERS:
        np.testing.assert_allclose(tparams[name]["w"].numpy(), np.asarray(jparams[name]["w"]), atol=1e-4)
    assert ttrain.best_static_action(traces) == jtrain.best_static_action(traces)
    np.testing.assert_array_equal(ttrain._standardize(traces["scalars"]), jtrain._standardize(traces["scalars"]))


def test_train_selector_with_dropout_runs_on_its_own_init():
    _, tcfg = _cfgs(32, 32)
    traces = _trace_batch(20, 32, 32, len(ACTIONS), seed=9)
    p1, l1 = ttrain.train_selector(traces, tcfg, steps=5, batch=8, seed=1, device="cpu")
    p2, l2 = ttrain.train_selector(traces, tcfg, steps=5, batch=8, seed=1, device="cpu")
    assert l1 == l2 and all(np.isfinite(l1))
    assert all(torch.equal(p1[n]["w"], p2[n]["w"]) for n in tsel.LAYERS)


# ------------------------------------------------------ offline traces ---


def test_collect_traces_matches_jax():
    jt = j_get_smoke("granite-8b").replace(dtype="float32")
    tt = t_get_smoke("granite-8b").replace(dtype="float32")
    jd, td = j_make_draft_cfg(jt), t_make_draft_cfg(tt)
    jtp, jdp = j_init_params(jt, jax.random.PRNGKey(0)), j_init_params(jd, jax.random.PRNGKey(1))
    ttp, tdp = (bridge.params_from_jax(_np(p), device="cpu", dtype=torch.float32) for p in (jtp, jdp))
    lat = (1e-4, 1e-8, 1.2e-3, 1e-7)
    prompts = [[5, 1, 7, 2, 9], [300, 4, 4]]
    out = []
    for mod, dmod, args in ((jeng, jdelayed, (jt, jtp, jd, jdp)), (teng, tdelayed, (tt, ttp, td, tdp))):
        eng = mod.SpeculativeEngine(*args, mod.EngineConfig("specinfer", 2, 1, 1, max_cache=64, seed=3),
                                    mod.SamplingParams(0.9, 1.0))
        trainer = jtrain if mod is jeng else ttrain
        out.append(trainer.collect_traces(eng, prompts, ACTIONS[1:3], dmod.LatencyModel(*lat),
                                          tokens_per_prompt=6, stride=3, s=1, seed=4))
    want, got = out
    assert set(got) == set(want) == {"h_prev_p", "h_prev_q", "h_cur_q", "scalars", "eff", "time"}
    assert got["eff"].shape[0] >= 4
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
