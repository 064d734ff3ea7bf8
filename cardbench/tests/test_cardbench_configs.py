"""The configuration files hold the widths the benchmark states, and
``BENCHMARK.json`` names only files and readers that exist."""
import json
import re

import pytest
import torch

from harness import spec
from harness.weights import draw_pair, model_configs

WIDTHS = {
    "granite-8b": (
        dict(arch_type="dense", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, hd=128, d_ff=14336,
             vocab=49152, dtype="bfloat16"),
        dict(arch_type="dense", n_layers=9, d_model=2048, n_heads=16, n_kv_heads=4, hd=128, d_ff=7168,
             vocab=49152, dtype="bfloat16"),
        8254689280, 692099072),
}
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_widths_as_stated(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    assert config["reduced"] == entry["reduced"]
    tgt, drf = model_configs(config)
    want_t, want_d, n_t, n_d = WIDTHS[name]
    for cfg, want in ((tgt, want_t), (drf, want_d)):
        for k, v in want.items():
            assert getattr(cfg, k) == v, (name, k)
    # the counts the file states, from the shapes of the leaves draw_pair makes
    for cfg, n, role in ((tgt, n_t, "target"), (drf, n_d, "draft")):
        assert _count(cfg) == n == config["params"][role]


def _count(cfg):
    d, hd, V, f, L = cfg.d_model, cfg.hd, cfg.vocab, cfg.d_ff, cfg.n_layers
    per = 2 * d + 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    per += 3 * d * f
    return 2 * V * d + d + L * per


def _sizes(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _sizes(v)
        else:
            yield v.numel(), v.dtype


SMALL = {"target": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 32,
                    "vocab": 128, "dtype": "float32"},
         "draft": {"n_layers": 1, "d_model": 32, "n_heads": 2, "n_kv_heads": 1, "head_dim": 16, "d_ff": 16,
                   "vocab": 128, "dtype": "float32"}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, (tuple(v.shape), v.dtype)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_draw_matches_the_port_layout(name):
    """Every leaf the port's init_params makes, with its shape and dtype,
    at small widths, target and draft."""
    from repro_torch.models.transformer import init_params

    config = json.loads((spec.ROOT / f"cardbench/configs/{name}.json").read_text())
    tgt, drf = model_configs(config, SMALL)
    ours = draw_pair(config, tgt, drf, 1, "cpu")
    for cfg, got in zip((tgt, drf), ours):
        port = init_params(cfg, torch.Generator().manual_seed(1))
        assert sum(n for n, _ in _sizes(got)) == _count(cfg)
        assert dict(_leaves(got)) == dict(_leaves(port))


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_draft_is_tied_to_the_target(name):
    """The draft's embedding and head are the target's through one
    projection: with the blocks left out, both models put first the same
    token at every position."""
    from reference import llama

    config = json.loads((spec.ROOT / f"cardbench/configs/{name}.json").read_text())
    tgt, drf = model_configs(config, SMALL)
    tp, dp = draw_pair(config, tgt, drf, 7, "cpu")
    tok = torch.arange(128)
    firsts = []
    for p, c in ((tp, tgt), (dp, drf)):
        x = llama._rms(p["embed"][tok].float(), p["final_ln"], c.norm_eps)
        firsts.append((x @ p["lm_head"].float()).argmax(dim=-1))
    assert torch.equal(firsts[0], firsts[1])


def test_same_seed_same_weights():
    config = json.loads((spec.ROOT / "cardbench/configs/granite-8b.json").read_text())
    tgt, drf = model_configs(config, SMALL)
    (a, ad), (b, bd) = (draw_pair(config, tgt, drf, 2**31 + 5, "cpu") for _ in range(2))
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert torch.equal(a["lm_head"], b["lm_head"]) and torch.equal(ad["lm_head"], bd["lm_head"])


def test_benchmark_names_files_and_readers():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] + \
            [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert cell.limits["numbers"] and cell.traffic["loop"] == "closed"
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(spec.metric_reader(m["name"]))
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
