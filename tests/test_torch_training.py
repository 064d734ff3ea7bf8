"""The port's training path against the JAX package, on the CPU, in float32.

Same weights (bridged from JAX), same batches made with numpy:

  * ``SyntheticLM`` and ``MemmapDataset`` give JAX's batches for the same
    seeds;
  * a checkpoint written by either package loads in the other, bf16 leaves
    and nesting bit for bit;
  * the MoE capacity-factor dispatch (``train=True``): the capacity, the
    dropped (token, choice) pairs, the output, the aux loss and the
    gradients equal JAX's on a batch where pairs drop;
  * for every ``list_arches()`` smoke config: ``loss_fn`` within 1e-5
    relative, every gradient leaf within 1e-4 of its own largest |value|
    with remat on and off, and the parameters after three
    ``make_train_step`` steps within 1e-4;
  * in bf16, AdamW's moments take JAX's dtype (float32 under the clip) and
    values, on the same gradients and through three train steps of the
    granite smoke;
  * ``kernels.ops.refuse_grad`` refuses a tensor that requires grad on a
    CUDA device type (no card needed), a training pass refuses a cache, and
    the launcher trains on the CPU (and, without a process group of 256
    ranks, refuses ``--distributed``).
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke as j_get_smoke
from repro.configs import list_arches
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.training import checkpoint as jck
from repro.training import data as jdata
from repro.training.optim import AdamW as JAdamW
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.training import checkpoint as tck
from repro_torch.training import data as tdata
from repro_torch.training.loop import to_device
from repro_torch.training.optim import AdamW as TAdamW
from repro_torch.training.optim import tree_leaves

B, T = 2, 8
STEPS = 3
# AdamW's eps at 1e-5 bounds d(update)/d(grad) by lr / eps: at the default
# 1e-8 an element whose gradient is ~1e-7 turns float32 rounding of its
# gradient into an update difference of ~1e-4 after a few steps
OPT = dict(lr=1e-3, eps=1e-5)


def to_torch_cfg(jcfg) -> TConfig:
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})


def _bridge(p):
    return bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu", dtype=torch.float32)


def _flat(tree, prefix=""):
    """{path: numpy} of a nested dict of JAX arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree)}


def _batch(cfg, seed):
    """Tokens and next-token labels (the last one masked), with the family's
    frames or patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    b["labels"][:, -1] = -1
    if cfg.arch_type == "encdec":
        b["enc_embeds"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    elif cfg.arch_type == "vlm":
        b["embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


# ------------------------------------------------------------------ data ---


def test_synthetic_and_memmap_batches_equal_jax(tmp_path):
    for vocab, seed, bseed in ((64, 1, 5), (256, 3, 1), (49155, 0, 0)):
        j_it = jdata.SyntheticLM(vocab, seed=seed).batches(3, 17, seed=bseed)
        t_it = tdata.SyntheticLM(vocab, seed=seed).batches(3, 17, seed=bseed)
        for _ in range(2):
            jb, tb = next(j_it), next(t_it)
            for key in ("tokens", "labels"):
                assert tb[key].dtype == jb[key].dtype
                np.testing.assert_array_equal(tb[key], jb[key])
    path = str(tmp_path / "tokens.bin")
    np.arange(5000, dtype=np.uint16).tofile(path)
    jb = next(jdata.MemmapDataset(path, 5000).batches(4, 32, seed=2))
    tb = next(tdata.MemmapDataset(path, 5000).batches(4, 32, seed=2))
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(tb[key], jb[key])


# ----------------------------------------------------------- checkpoints ---


def test_checkpoints_interchange_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    bf16 = rng.standard_normal((4, 6)).astype(np.float32)
    jtree = {"a": jnp.asarray(bf16, jnp.bfloat16),
             "nested": {"b": jnp.arange(5, dtype=jnp.float32), "deep": {"c": jnp.ones((2, 3), jnp.int32)}}}
    ttree = {"a": torch.from_numpy(bf16).to(torch.bfloat16),
             "nested": {"b": torch.arange(5, dtype=torch.float32), "deep": {"c": torch.ones((2, 3), dtype=torch.int32)}}}

    def bits(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    # JAX writes, the port reads
    jpath = str(tmp_path / "jax.npz")
    jck.save_checkpoint(jpath, jtree, step=7)
    got, step = tck.load_checkpoint(jpath, template=ttree, device="cpu")
    assert step == 7 and sorted(got) == sorted(ttree) and sorted(got["nested"]) == sorted(ttree["nested"])
    pairs = ((got["a"], jtree["a"]), (got["nested"]["b"], jtree["nested"]["b"]),
             (got["nested"]["deep"]["c"], jtree["nested"]["deep"]["c"]))
    assert [t.dtype for t, _ in pairs] == [torch.bfloat16, torch.float32, torch.int32]
    for t, j in pairs:
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(bits(t), np.asarray(j).view(bits(t).dtype))
    flat, _ = tck.load_checkpoint(jpath, device="cpu")
    assert sorted(flat) == ["a", "nested/b", "nested/deep/c"]

    # the port writes, JAX reads
    tpath = str(tmp_path / "torch.npz")
    tck.save_checkpoint(tpath, ttree, step=3, meta={"arch": "x"})
    back, step = jck.load_checkpoint(tpath, template=jtree)
    assert step == 3
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))
    assert os.path.exists(tpath + ".meta.json")


# --------------------------------------------------- the capacity dispatch ---


def _jax_dropped(jp, jcfg, x, C):
    """The (token, choice) pairs JAX's capacity dispatch drops: the slot rule
    of src/repro/models/moe.py (stable argsort ranks within each expert),
    from JAX's own router."""
    E, k = jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1]) @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    hist = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(hist)[:-1]])
    slot = jnp.zeros(flat_e.shape, jnp.int32).at[order].set(jnp.arange(flat_e.shape[0]) - starts[flat_e[order]])
    return np.asarray(slot >= C).reshape(-1, k)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"])
def test_capacity_dispatch_drops_what_jax_drops(arch):
    jcfg = j_get_smoke(arch).replace(dtype="float32")
    tcfg = to_torch_cfg(jcfg)
    for n in (1, 7, 16, 40, 100, 1024):
        assert tmoe.moe_capacity(n, tcfg, train=True) == jmoe.moe_capacity(n, jcfg, train=True)
    assert tmoe.moe_capacity(40, tcfg.replace(capacity_factor=0.0), train=True) == 40  # dropless
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    tp = _bridge(jp)
    # inputs leaning towards expert 0's router column, so its buffer overflows
    rng = np.random.default_rng(4)
    lean = np.asarray(jp["router"])[:, 0] / np.linalg.norm(np.asarray(jp["router"])[:, 0])
    x = (rng.standard_normal((2, 20, jcfg.d_model)) * 0.5 + 4 * lean).astype(np.float32)
    C = jmoe.moe_capacity(40, jcfg, train=True)
    want = _jax_dropped(jp, jcfg, x, C)
    _, _, _, slot = tmoe.route(tp, tcfg, torch.from_numpy(x).reshape(-1, jcfg.d_model))
    got = (slot >= C).reshape(-1, jcfg.top_k).numpy()
    assert want.sum() > 0, "the batch must overflow an expert"
    np.testing.assert_array_equal(got, want)

    def jloss(p, xs):
        y, aux = jmoe.moe_apply(p, jcfg, xs, train=True)
        return jnp.sum(y * jnp.arange(y.size, dtype=jnp.float32).reshape(y.shape) / y.size) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tleaves = {k: v.requires_grad_() for k, v in tp.items()}
    ty, taux = tmoe.moe_apply(tleaves, tcfg, tx, train=True)
    tl = torch.sum(ty * torch.arange(ty.numel(), dtype=torch.float32).reshape(ty.shape) / ty.numel()) + taux
    tl.backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-5, rtol=0)
    # a dropped pair adds nothing: the dropless output differs on its tokens
    dropless, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    moved = (dropless - ty).abs().amax(dim=-1).reshape(-1).detach().numpy() > 1e-6
    np.testing.assert_array_equal(moved, want.any(axis=1))
    for name, g in list(jg.items()) + [("x", jgx)]:
        t = tx.grad if name == "x" else tleaves[name].grad
        scale = float(np.abs(np.asarray(g)).max())
        assert np.abs(t.numpy() - np.asarray(g)).max() <= 1e-4 * scale, name


# ------------------------------------------------ loss, gradients, steps ---


@pytest.fixture(scope="module")
def jax_runs():
    """Per arch, computed once: JAX's float32 smoke params, the loss and
    gradients of the first batch, and the params after STEPS steps: one
    compiled scan of STEPS (value_and_grad, AdamW update) steps a config."""
    cache = {}

    def run(arch):
        if arch not in cache:
            jcfg = j_get_smoke(arch).replace(dtype="float32")
            jp = jax.jit(jt.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
            opt = JAdamW(**OPT)

            def lf(p, b):
                return jt.loss_fn(p, jcfg, b["tokens"], b["labels"], embeds=b.get("embeds"),
                                  enc_embeds=b.get("enc_embeds"))

            def step(carry, b):
                loss, g = jax.value_and_grad(lf)(carry[0], b)
                return opt.update(g, carry[1], carry[0]), (loss, g)

            @jax.jit
            def steps(p, batches):
                (p, _), (losses, grads) = jax.lax.scan(step, (p, opt.init(p)), batches)
                return p, losses[0], jax.tree.map(lambda g: g[0], grads)

            batches = [_batch(jcfg, i) for i in range(STEPS)]
            stacked = {k: jnp.asarray(np.stack([b[k] for b in batches])) for k in batches[0]}
            after, loss0, grads0 = steps(jp, stacked)
            cache[arch] = (jcfg, jp, float(loss0), _flat(grads0), _flat(after))
        return cache[arch]

    return run


@pytest.mark.parametrize("arch", list_arches())
def test_loss_grads_and_steps_match_jax(jax_runs, arch):
    jcfg, jp, jloss, jgrads, jafter = jax_runs(arch)
    tcfg = to_torch_cfg(jcfg)
    assert tcfg.remat
    batch = to_device(_batch(jcfg, 0), "cpu")
    for cfg in (tcfg, tcfg.replace(remat=False)):
        loss, grads = tt.loss_and_grads(_bridge(jp), cfg, batch)
        loss, grads = loss.item(), _flat(grads)
        assert abs(loss - jloss) <= 1e-5 * abs(jloss), (cfg.remat, loss, jloss)
        assert sorted(grads) == sorted(jgrads)
        for name, g in jgrads.items():
            scale = float(np.abs(g).max())
            err = float(np.abs(grads[name] - g).max())
            assert err <= 1e-4 * scale, f"remat={cfg.remat} {name}: {err} against scale {scale}"
    opt = TAdamW(**OPT)
    step = tt.make_train_step(tcfg, opt)
    p = _bridge(jp)
    st = opt.init(p)
    for i in range(STEPS):
        p, st, loss = step(p, st, to_device(_batch(jcfg, i), "cpu"))
        if i == 0:
            assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    assert not any(t.requires_grad for t in tree_leaves(p))
    after = _flat(p)
    moved = 0.0
    for name, want in jafter.items():
        np.testing.assert_allclose(after[name], want, atol=1e-4, rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(want - np.asarray(_flat(jp)[name])).max()))
    assert moved > 10 * 1e-4, "the steps must move the parameters past the tolerance"


# ------------------------------------------------------------------ bf16 ---


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_on_bf16_params_matches_jax(clip_norm):
    """Three updates of bf16 and float32 leaves from the same gradients (the
    second all zeros, so only the decay moves the moments).  Under the clip
    JAX's moments are float32 (its float32 scale promotes the gradients)
    and the port's must be too, within 1e-5 of each leaf's largest |value|,
    the bf16 parameters bit for bit.  Without it the moments are bf16 in both,
    within 2 bf16 ulps (they agree bit for bit: both scale by the bf16-rounded
    b1, b2).  JAX's update runs un-jitted, so each of its ops rounds alone, as
    torch's do; jitted, XLA's CPU backend fuses the bf16 update and rounds it
    as the host's bf16 support makes it."""
    rng = np.random.default_rng(0)
    shapes = {"a": ((64, 48), "bfloat16"), "b": {"c": ((32,), "bfloat16")}, "d": ((16,), "float32")}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(*v) for k, v in s.items()}

    p0 = tree(lambda sh, dt: (rng.standard_normal(sh) * 0.02).astype(np.float32))
    gs = [tree(lambda sh, dt: (rng.standard_normal(sh) * 0.5).astype(np.float32)) for _ in range(2)]
    gs.insert(1, tree(lambda sh, dt: np.zeros(sh, np.float32)))
    dts = tree(lambda sh, dt: dt)
    jcast = lambda t: jax.tree.map(lambda x, d: jnp.asarray(x, getattr(jnp, d)), t, dts)
    tcast = lambda t: jax.tree.map(lambda x, d: torch.from_numpy(x).to(getattr(torch, d)), t, dts)
    kw = dict(clip_norm=clip_norm, warmup_steps=1, lr=1e-3)
    jo, to = JAdamW(**kw), TAdamW(**kw)
    jp, tp = jcast(p0), tcast(p0)
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        jp, js = jo.update(jcast(g), js, jp)
        tp, ts = to.update_(tcast(g), ts, tp)
    tol = 1e-5 if clip_norm else 2 * 2.0**-7
    for what, j, t in (("params", jp, tp), ("mu", js.mu, ts.mu), ("nu", js.nu, ts.nu)):
        for a, b in zip(jax.tree.leaves(j), tree_leaves(t)):
            assert str(b.dtype).removeprefix("torch.") == str(a.dtype), what
            bf16 = b.dtype == torch.bfloat16
            a, b = np.asarray(a.astype(jnp.float32)), b.float().numpy()
            err = float(np.abs(a - b).max())
            if what == "params" and clip_norm and bf16:
                assert err == 0.0, what
            assert err <= tol * float(np.abs(a).max()), (what, err)
    # update is update_ on copies: its inputs stay as they were
    before = tcast(p0)
    state = to.init(before)
    after, new = to.update(tcast(gs[0]), state, before)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(before), tree_leaves(tcast(p0))))
    assert not any(x.any() for x in tree_leaves(state.mu)) and any(x.any() for x in tree_leaves(new.mu))
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(after), tree_leaves(before)))


def test_bf16_train_steps_match_jax():
    """Three steps of the granite smoke in its own bf16 through both
    packages' ``make_train_step`` (AdamW with the clip): every moment is
    float32 as JAX's, each step's loss within 1e-3 relative, each moment
    leaf within 0.1 of its largest |value| (the two bf16 forward passes
    round differently, so the gradients differ by up to ~3 % of a leaf's
    scale; the update's own arithmetic is held above)."""
    jcfg = j_get_smoke("granite-3-2b")
    assert jcfg.dtype == "bfloat16"
    tcfg = to_torch_cfg(jcfg)
    jp = jax.jit(jt.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    jo, to = JAdamW(**OPT), TAdamW(**OPT)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.bfloat16)
    js, ts = jo.init(jp), to.init(tp)
    jstep, tstep = jax.jit(jt.make_train_step(jcfg, jo)), tt.make_train_step(tcfg, to)
    for i in range(STEPS):
        b = _batch(jcfg, i)
        jp, js, jl = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tl = tstep(tp, ts, to_device(b, "cpu"))
        assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl)), (i, float(tl), float(jl))
    assert [str(t.dtype) for t in tree_leaves(tp)] == [f"torch.{a.dtype}" for a in jax.tree.leaves(jp)]
    for j, t in ((js.mu, ts.mu), (js.nu, ts.nu)):
        for a, b in zip(jax.tree.leaves(j), tree_leaves(t)):
            assert a.dtype == jnp.float32 and b.dtype == torch.float32
            a = np.asarray(a)
            assert float(np.abs(a - b.numpy()).max()) <= 0.1 * float(np.abs(a).max())


# ------------------------------------------------------------- guard, CLI ---


def test_refuse_grad_names_the_reason():
    q = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.refuse_grad("tree_attention", "cuda", torch.zeros(1), q)
    with torch.no_grad():
        ops.refuse_grad("tree_attention", "cuda", q)  # no grad mode: nothing to lose
    ops.refuse_grad("tree_attention", "cuda", q.detach())
    ops.refuse_grad("tree_attention", "cpu", q)  # the plain versions are differentiable
    # on the CPU every wrapper takes its plain version and keeps the graph
    k = torch.randn(1, 4, 1, 8, requires_grad=True)
    out = ops.gqa_tree_attention(torch.randn(1, 2, 2, 8), k, torch.randn(1, 4, 1, 8),
                                 torch.ones(1, 2, 4, dtype=torch.bool))
    assert out.grad_fn is not None


def test_a_training_pass_takes_no_cache():
    cfg = to_torch_cfg(j_get_smoke("granite-3-2b").replace(dtype="float32"))
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="without a cache"):
        tt.forward(params, cfg, torch.zeros((1, 4), dtype=torch.long), cache=tt.init_cache(cfg, 1, 16, "cpu"),
                   train=True)


def test_train_launcher_on_the_cpu(capsys, tmp_path):
    ck = str(tmp_path / "ck.npz")
    ttrain.main(["--device", "cpu", "--smoke", "--arch", "granite-3-2b", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "final loss:" in out
    params, step = tck.load_checkpoint(ck, device="cpu")
    assert step == 2 and "embed" in params
    # the production mesh needs a process group of 256 ranks (torchrun), and this process has none
    with pytest.raises(RuntimeError, match="found world size 0"):
        ttrain.main(["--device", "cpu", "--smoke", "--arch", "granite-3-2b", "--distributed"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            ttrain.main(["--smoke", "--arch", "granite-3-2b"])
