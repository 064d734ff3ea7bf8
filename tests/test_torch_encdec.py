"""The port's encoder-decoder (whisper-medium) and VLM (internvl2-26b)
families against the JAX package, on the CPU.

Same weights (bridged from JAX), same inputs made from a seed with numpy,
float32, the smokes as their ``smoke()`` gives them (Whisper's enc_len 24):

  * ``forward`` on both smokes: "full" without a cache, a prefill into a
    cache (Whisper given its frames, InternVL its patches), a decode and a
    delayed-tree pass reading the cached cross K/V; the VLM with
    ``tokens=None``.  Logits, hidden states and the caches (k, v, cross_k,
    cross_v within 1e-4; pos, len exact), under both JAX attention paths;
  * the decode-consistency law of tests/test_models.py on the port;
  * the port's init draws the JAX tree, and the bridge keeps ``ln_x`` and
    ``enc_ln`` float32 in a bf16 model;
  * the stream helpers carry the cross cache along its batch axis, bit for
    bit against JAX;
  * ``SpeculativeEngine`` emits the JAX engine's tokens and counters on both
    smokes (3 requests with frames or patches) under specinfer and
    traversal; the batched engines refuse both families with JAX's reason;
  * the JAX engine's quirks the port keeps (ROADMAP queue 3): the enc-dec
    draft never sees the audio, the VLM draft never sees the patches (its
    positions trail the target's by n_patches), a one-token VLM prompt
    feeds the patches unprojected, the launcher serves internvl2 text-only;
  * the launcher prints the JAX launcher's tokens for whisper-medium.
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import internvl2_26b, whisper_medium
from repro.core.trees import tree_ancestor_mask
from repro.launch import serve as jserve
from repro.models import cache as jc
from repro.models import transformer as jt
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.launch import serve as tserve
from repro_torch.models import cache as tc
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import batch_engine as tbe
from repro_torch.serving import engine as teng

ATOL = 1e-4
SMAX = 64
SMOKES = {"whisper-medium": whisper_medium.smoke(), "internvl2-26b": internvl2_26b.smoke()}
PROMPTS = [[5, 1, 7, 2], [9, 4, 6], [3, 8, 11, 2, 7]]
MAX_NEW = [8, 6, 7]
REASON = "batched serving covers decoder-only archs"


def to_torch_cfg(jcfg) -> TConfig:
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bridge(jp, dtype=torch.float32):
    return bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", dtype=dtype)


def _close(t, j, what):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=ATOL, rtol=0, err_msg=what)


def _close_caches(tcache, jcache):
    tn, jn = bridge.cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    assert sorted(tn) == sorted(jn) and sorted(tn["attn"]) == sorted(jn["attn"])
    for name in ("pos", "len"):
        np.testing.assert_array_equal(tn["attn"][name], jn["attn"][name])
    for name in ("k", "v"):
        _close(tn["attn"][name], jn["attn"][name], f"attn {name}")
    for name in ("cross_k", "cross_v"):
        if name in jn:
            _close(tn[name], jn[name], name)


def _modality(jcfg, rng, B, T=None):
    """The family's extra input: Whisper's frames (B, enc_len, d) as
    ``enc_embeds``, InternVL's patches (B, T or n_patches, d) as ``embeds``."""
    if jcfg.arch_type == "encdec":
        return "enc_embeds", rng.standard_normal((B, jcfg.enc_len, jcfg.d_model)).astype(np.float32)
    return "embeds", rng.standard_normal((B, T or jcfg.n_patches, jcfg.d_model)).astype(np.float32)


# ----------------------------------------------------------------- forward ---

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list(SMOKES))
def test_forward_matches_jax(arch, impl):
    jcfg = SMOKES[arch].replace(dtype="float32", attention_impl=impl)
    tcfg = to_torch_cfg(jcfg)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    rng = np.random.default_rng(1)
    jfwd = jax.jit(jt.forward, static_argnames=("cfg", "mode"))

    def both(tokens, mode, jcache=None, tcache=None, anc=None, **kw):
        jl, jcache, jex = jfwd(jp, jcfg, None if tokens is None else jnp.asarray(tokens), mode=mode, cache=jcache,
                               anc=None if anc is None else jnp.asarray(anc),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, tcache, tex = tt.forward(tp, tcfg, None if tokens is None else _t(tokens), mode=mode, cache=tcache,
                                     anc=None if anc is None else _t(anc), **{k: _t(v) for k, v in kw.items()})
        _close(tl, jl, f"{mode} logits")
        _close(tex["hidden"], jex["hidden"], f"{mode} hidden")
        if jcache is not None:
            _close_caches(tcache, jcache)
        return jcache, tcache

    name, extra = _modality(jcfg, rng, 2)
    both(rng.integers(0, jcfg.vocab, size=(2, 6)), "full", **{name: extra})
    if arch == "internvl2-26b":  # tokens=None: the embeddings replace the tokens, unprojected
        both(None, "full", embeds=_modality(jcfg, rng, 2, T=5)[1])
    name, extra = _modality(jcfg, rng, 1)
    jcache, tcache = both(rng.integers(0, jcfg.vocab, size=(1, 5)), "full", jt.init_cache(jcfg, 1, SMAX),
                          tt.init_cache(tcfg, 1, SMAX, "cpu"), **{name: extra})
    jcache, tcache = both(rng.integers(0, jcfg.vocab, size=(1, 2)), "decode", jcache, tcache)
    parent = np.array([-1, 0, 1, 2, 1, 4])
    both(rng.integers(0, jcfg.vocab, size=(1, len(parent))), "tree", jcache, tcache,
         anc=tree_ancestor_mask(parent)[None])


@pytest.mark.parametrize("arch", list(SMOKES))
def test_decode_consistency(arch):
    """tests/test_models.py's law on the port: a prefill then one decode
    gives the last logits of the full causal pass over the same tokens."""
    B, T = 2, 16
    tcfg = to_torch_cfg(SMOKES[arch].replace(dtype="float32"))
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    toks = _t(rng.integers(0, tcfg.vocab, (B, T)))
    name, extra = _modality(tcfg, rng, B)
    kw = {name: _t(extra)}
    lg, cache, _ = tt.forward(tp, tcfg, toks, mode="full", cache=tt.init_cache(tcfg, B, 64, "cpu"), **kw)
    nxt = lg[:, -1:].argmax(-1)
    lg2, cache, _ = tt.forward(tp, tcfg, nxt, mode="decode", cache=cache)
    lg_full, _, _ = tt.forward(tp, tcfg, torch.cat([toks, nxt], 1), mode="full", **kw)
    if tcfg.arch_type == "vlm":
        lg_full = lg_full[:, tcfg.n_patches:]
        assert int(cache["attn"]["len"]) == tcfg.n_patches + T + 1
    err = (lg2[:, -1] - lg_full[:, -1]).abs().max().item()
    assert err < 2e-4, err


def test_init_params_and_bridge_keep_fp32_leaves():
    """A bf16 model: the port's init draws the JAX package's tree and dtypes
    (patch_proj, enc_blocks, enc_ln, ln_x, xattn), and the bridge rounds
    the projections to bf16 but keeps ln_x and enc_ln float32, as JAX does."""
    for arch, jcfg in SMOKES.items():
        shapes_j = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0))))
        tp = tt.init_params(to_torch_cfg(jcfg), torch.Generator().manual_seed(0))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp) == shapes_j
        jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
        bp = _bridge(jp, torch.bfloat16)
        assert jax.tree.map(lambda t: str(t.dtype).replace("torch.", ""), bp) == \
            jax.tree.map(lambda a: str(a.dtype), jp)
        if arch == "whisper-medium":
            assert bp["enc_ln"].dtype == bp["blocks"]["ln_x"].dtype == torch.float32
            assert bp["blocks"]["xattn"]["wq"].dtype == bp["enc_blocks"]["attn"]["wk"].dtype == torch.bfloat16
        else:
            assert bp["patch_proj"].dtype == torch.bfloat16


def test_unknown_arch_type_raises_value_error():
    tcfg = to_torch_cfg(SMOKES["whisper-medium"]).replace(arch_type="conv")
    for fn in (lambda: tt.init_params(tcfg, torch.Generator()), lambda: tt.init_cache(tcfg, 1, SMAX, "cpu"),
               lambda: tt.forward({}, tcfg, torch.zeros((1, 1), dtype=torch.long))):
        with pytest.raises(ValueError, match="conv"):
            fn()


# ----------------------------------------------------------- stream helpers ---

def _same(tcache, jcache):
    tn, jn = bridge.cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(tn) == jax.tree.structure(jn)
    for a, b in zip(jax.tree.leaves(tn), jax.tree.leaves(jn)):
        np.testing.assert_array_equal(a, b)


def _cross_pool(rng):
    """The same random per-stream encdec cache (3 rows) in JAX and the port."""
    jcfg = SMOKES["whisper-medium"].replace(dtype="float32")
    leaves = jax.tree.map(np.asarray, jt.init_cache(jcfg, 3, 16, per_stream=True))
    filled = jax.tree.map(lambda a: rng.integers(-1, 16, size=a.shape).astype(a.dtype) if a.dtype.kind == "i"
                          else rng.standard_normal(a.shape).astype(a.dtype), leaves)
    return jax.tree.map(jnp.asarray, filled), jax.tree.map(_t, filled)


def test_stream_helpers_carry_the_cross_cache():
    rng = np.random.default_rng(5)
    jpool, tpool = _cross_pool(rng)
    assert tpool["cross_k"].shape[1] == 3
    _same(tc.gather_streams(tpool, [2, 0]), jc.gather_streams(jpool, jnp.asarray([2, 0])))
    _same(tc.fork_streams(tpool, 2), jc.fork_streams(jpool, 2))
    trows, jrows = tc.gather_streams(tpool, [1, 0]), jc.gather_streams(jpool, jnp.asarray([1, 0]))
    _same(tc.concat_streams([trows, tc.gather_streams(tpool, [2])]),
          jc.concat_streams([jrows, jc.gather_streams(jpool, jnp.asarray([2]))]))
    jother, tother = _cross_pool(np.random.default_rng(6))
    keep = np.asarray([True, False, True])
    _same(tc.merge_streams(tother, tpool, keep), jc.merge_streams(jother, jpool, jnp.asarray(keep)))
    _same(tc.scatter_streams(tpool, trows, [0, 1]), jc.scatter_streams(jpool, jrows, jnp.asarray([0, 1])))
    # clone_cache shares the cross cache: nothing writes it in place
    assert tc.clone_cache(tpool)["cross_k"] is tpool["cross_k"]


# ------------------------------------------------------------------ engines ---

_FAMILIES = {}


def _family(arch):
    """The smoke's float32 target and make_draft_cfg draft, bridged, one JAX
    jit cache for the family, and the seeded frames or patches (built once
    a module)."""
    if arch not in _FAMILIES:
        _FAMILIES[arch] = _build_family(arch)
    return _FAMILIES[arch]


def _build_family(arch):
    jtcfg = SMOKES[arch].replace(dtype="float32")
    jdcfg = jserve.make_draft_cfg(jtcfg)
    init = jax.jit(jt.init_params, static_argnums=0)
    jtp, jdp = init(jtcfg, jax.random.PRNGKey(0)), init(jdcfg, jax.random.PRNGKey(1))
    tdcfg = tserve.make_draft_cfg(to_torch_cfg(jtcfg))
    assert tdcfg == to_torch_cfg(jdcfg)
    name, extra = _modality(jtcfg, np.random.default_rng(2), 1)
    return {"arch": arch, "jax": (jtcfg, jtp, jdcfg, jdp),
            "torch": (to_torch_cfg(jtcfg), _bridge(jtp), tdcfg, _bridge(jdp)), "jit": {},
            "kw": {"jax": {name: jnp.asarray(extra)}, "torch": {name: _t(extra)}}}


@pytest.fixture(scope="module", params=list(SMOKES))
def family(request):
    return _family(request.param)


def _engine(family, side, verifier="specinfer", seed=3):
    mod = jeng if side == "jax" else teng
    eng = mod.SpeculativeEngine(*family[side], mod.EngineConfig(verifier, 2, 1, 2, max_cache=SMAX, seed=seed))
    if side == "jax":
        eng._jit_cache = family["jit"]
    return eng


@pytest.mark.parametrize("verifier", ["specinfer", "traversal"])
def test_engine_matches_jax(family, verifier):
    prompts = list(PROMPTS)
    if family["arch"] == "internvl2-26b":
        prompts[1] = [9]  # a one-token prompt: the patches alone are the prefill
    outs = []
    for side in ("jax", "torch"):
        eng = _engine(family, side, verifier)
        toks = [eng.generate(p, max_new=m, **family["kw"][side]) for p, m in zip(prompts, MAX_NEW)]
        outs.append((toks, dict(eng.counters)))
    assert outs[1] == outs[0]
    assert outs[0][1]["accepted"] > 0


def test_batched_engines_refuse_encdec_and_vlm(family):
    tcfg, tp, dcfg, dp = family["torch"]
    for cls in (tbe.BatchedSpeculativeEngine, tbe.ShardedBatchedSpeculativeEngine):
        with pytest.raises(ValueError, match=REASON):
            cls(tcfg, tp, dcfg, dp, teng.EngineConfig())


def _streams(family, prompt):
    return {side: _engine(family, side).new_stream(prompt, **family["kw"][side]) for side in ("jax", "torch")}


def test_encdec_draft_never_sees_the_audio():
    """JAX's ``new_stream`` gives the frames to the target only: the draft's
    cross-attention reads its zero cross_k/cross_v and adds 0."""
    family = _family("whisper-medium")
    s = _streams(family, PROMPTS[0])
    for side in ("jax", "torch"):
        d = bridge.cache_to_numpy(s[side]["dcache"]) if side == "torch" else jax.tree.map(np.asarray,
                                                                                           s[side]["dcache"])
        assert not d["cross_k"].any() and not d["cross_v"].any()
    _close_caches(s["torch"]["tcache"], s["jax"]["tcache"])
    assert s["torch"]["tcache"]["cross_k"].abs().max() > 0
    _close(s["torch"]["h_prev_q"], s["jax"]["h_prev_q"], "draft hidden")


def test_vlm_draft_never_sees_the_patches():
    """The target's cache runs over n_patches + the context, the draft's
    over the context alone: its positions trail the target's by n_patches."""
    family = _family("internvl2-26b")
    s = _streams(family, PROMPTS[0])
    n, ctx = family["torch"][0].n_patches, len(PROMPTS[0]) - 1
    for side in ("jax", "torch"):
        assert int(s[side]["tcache"]["attn"]["len"]) == n + ctx
        assert int(s[side]["dcache"]["attn"]["len"]) == ctx
    _close_caches(s["torch"]["tcache"], s["jax"]["tcache"])
    _close_caches(s["torch"]["dcache"], s["jax"]["dcache"])


def test_one_token_vlm_prompt_feeds_the_patches_unprojected():
    """With no context the target's prefill is ``forward(tokens=None,
    embeds=patches)``: the patches replace the tokens and skip patch_proj."""
    family = _family("internvl2-26b")
    s = _streams(family, [9])
    tcfg, tp = family["torch"][:2]
    patches = family["kw"]["torch"]["embeds"]
    _, _, ex = tt.forward(tp, tcfg, None, cache=tt.init_cache(tcfg, 1, SMAX, "cpu"), embeds=patches)
    projected = tt.forward(tp, tcfg, None, embeds=patches @ tp["patch_proj"])[2]["hidden"]
    np.testing.assert_array_equal(s["torch"]["h_prev_p"], ex["hidden"][0, -1].numpy())
    assert not np.allclose(s["torch"]["h_prev_p"], projected[0, -1].numpy(), atol=1e-3)
    _close(s["torch"]["h_prev_p"], s["jax"]["h_prev_p"], "target hidden")
    assert int(s["torch"]["tcache"]["attn"]["len"]) == tcfg.n_patches and not s["torch"]["h_prev_q"].any()


# --------------------------------------------------------------------- CLI ---

def test_cli_serves_whisper_like_the_jax_launcher(capsys, monkeypatch):
    """``--arch whisper-medium --smoke`` draws the frames from the
    launcher's rng before the prompts, as the JAX launcher does: with
    float32 smokes and the JAX weights it prints the JAX launcher's tokens.
    ``--streams`` fails with JAX's reason."""
    jcfg = SMOKES["whisper-medium"].replace(dtype="float32")
    monkeypatch.setattr(jserve, "get_smoke", lambda name: jcfg)
    monkeypatch.setattr(tserve, "get_smoke", lambda name: to_torch_cfg(jcfg))

    def jax_weights(cfg, gen):
        return _bridge(jt.init_params(jcfg if cfg.name == jcfg.name else jserve.make_draft_cfg(jcfg),
                                      jax.random.PRNGKey(gen.initial_seed())))

    monkeypatch.setattr(tserve, "init_params", jax_weights)
    args = ["--arch", "whisper-medium", "--smoke", "--requests", "2", "--max-new", "6", "--L1", "1", "--L2", "1"]
    jserve.main(args)
    want = re.findall(r"req\d: \[.*\]", capsys.readouterr().out)
    tserve.main(args + ["--device", "cpu"])
    got = re.findall(r"req\d: \[.*\]", capsys.readouterr().out)
    assert got == want and len(want) == 2
    with pytest.raises(ValueError, match=REASON):
        tserve.main(args + ["--device", "cpu", "--streams", "2"])


def test_cli_serves_internvl_text_only(capsys, monkeypatch):
    """The JAX launcher serves internvl2 without patches; so does the port's."""
    seen = []
    generate = teng.SpeculativeEngine.generate

    def spy(self, prompt, max_new=64, **kw):
        seen.append(sorted(kw))
        return generate(self, prompt, max_new, **kw)

    monkeypatch.setattr(teng.SpeculativeEngine, "generate", spy)
    tserve.main(["--arch", "internvl2-26b", "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "4"])
    assert seen == [[], []] and "req1: [" in capsys.readouterr().out
