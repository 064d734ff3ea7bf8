"""The port's dry run (launch/shapes.py, launch/dryrun.py) against the JAX
package, on the CPU.

  * for every registered config and every shape, ``input_specs`` gives
    JAX's step kind and the same leaf paths, shapes and dtypes (the cache
    from the port's ``init_cache`` against ``jax.eval_shape`` of JAX's);
  * the port's ``init_params`` under ``FakeTensorMode`` gives JAX's leaf
    shapes, dtypes and parameter count (``jax.eval_shape``);
  * ``dry_run_one`` through ``cfg_override`` on a smoke config returns every
    key, its peak covers what is resident (and, for a train step, the
    parameters, their gradients and AdamW's moments), and its parameter
    count is JAX's;
  * ``main`` writes its JSON and exits 0, and exits 1 on an unknown arch.

The JAX side never imports ``repro.launch.dryrun``: its first lines change
XLA's host device count for the whole process.
"""
import json
from functools import partial

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # shape-only work; parallel test workers share the cores

import jax
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.launch import shapes as jshapes
from repro.models import transformer as jt
from repro_torch.configs import get_config, get_smoke, list_arches
from repro_torch.launch import dryrun, shapes
from repro_torch.models.transformer import init_params

ARCHES = list_arches()
KEYS = {"arch", "shape", "kind", "param_count", "param_bytes", "opt_bytes", "cache_bytes", "input_bytes",
        "resident_bytes", "flops_counted", "flops_model", "peak_bytes", "fits", "seconds"}


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _torch_leaves(sub, f"{prefix}['{key}']").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def test_the_registry_and_the_shape_table_are_jax_s():
    from repro.configs import list_arches as j_list_arches

    assert sorted(ARCHES) == sorted(j_list_arches())
    assert shapes.SHAPES == jshapes.SHAPES


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHES)
def test_input_specs_match_jax(arch, shape):
    j_kind, j_kw, j_cfg = jshapes.input_specs(j_get_config(arch), shape)
    kind, kw, cfg = shapes.input_specs(get_config(arch), shape)
    assert kind == j_kind
    assert (cfg.attention, cfg.window) == (j_cfg.attention, j_cfg.window)
    assert shapes.cache_smax(cfg, shape) == jshapes.cache_smax(j_cfg, shape)
    assert _torch_leaves(kw) == _jax_leaves(j_kw)
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor) for t in torch.utils._pytree.tree_leaves(kw))


@pytest.mark.parametrize("arch", ARCHES)
def test_fake_init_params_match_jax(arch):
    j_params = jax.eval_shape(partial(jt.init_params, j_get_config(arch)), jax.random.PRNGKey(0))
    with FakeTensorMode():
        params = init_params(get_config(arch), torch.Generator().manual_seed(0))
    assert _torch_leaves(params) == _jax_leaves(j_params)
    count = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    assert count == sum(x.size for x in jax.tree.leaves(j_params))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-235b-a22b", "whisper-medium"])
def test_dry_run_one_on_a_smoke_config(arch, kind):
    cfg = get_smoke(arch)
    r = dryrun.dry_run_one(arch, {"seq": 16, "batch": 2, "kind": kind}, cfg_override=cfg)
    assert set(r) == KEYS and r["kind"] == kind and r["shape"] == f"{kind}_16x2"
    j_params = jax.eval_shape(partial(jt.init_params, j_get_smoke(arch)), jax.random.PRNGKey(0))
    assert r["param_count"] == sum(x.size for x in jax.tree.leaves(j_params))
    assert r["resident_bytes"] == r["param_bytes"] + r["opt_bytes"] + r["cache_bytes"] + r["input_bytes"]
    assert r["peak_bytes"] >= r["resident_bytes"] and r["flops_counted"] > 0 and r["fits"]
    tokens = 2 * (1 if kind == "decode" else 16)
    assert r["flops_model"] > 0 and r["flops_model"] % tokens == 0
    if kind == "train":
        # the moments are float32 (AdamW under the clip), and the gradients are live with them
        assert r["opt_bytes"] == 2 * 4 * r["param_count"] and r["cache_bytes"] == 0
        assert r["peak_bytes"] >= 2 * r["param_bytes"] + r["opt_bytes"]
    else:
        assert r["opt_bytes"] == 0 and r["cache_bytes"] > 0


def _jax_bytes(tree) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


def test_dry_run_without_the_step_builds_only():
    """granite-8b at decode_32k, built only: the bytes are those of JAX's
    leaves, and it fits no card (the cache alone is 540 GiB)."""
    r = dryrun.dry_run_one("granite-8b", "decode_32k", count_flops=False)
    assert r["flops_counted"] is None and r["peak_bytes"] is None
    _, j_kw, _ = jshapes.input_specs(j_get_config("granite-8b"), "decode_32k")
    j_params = jax.eval_shape(partial(jt.init_params, j_get_config("granite-8b")), jax.random.PRNGKey(0))
    assert r["param_bytes"] == _jax_bytes(j_params) and r["cache_bytes"] == _jax_bytes(j_kw["cache"])
    assert r["input_bytes"] == _jax_bytes(j_kw["tokens"]) and r["opt_bytes"] == 0
    assert r["flops_model"] == 2 * r["param_count"] * 128
    assert not r["fits"] and r["resident_bytes"] > dryrun.H100_BYTES


def test_main_writes_json_and_exits_by_failures(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k", "--no-flops", "--out", str(out)]) == 0
    (r,) = json.loads(out.read_text())
    assert r["arch"] == "granite-3-2b" and r["shape"] == "long_500k" and r["fits"]
    assert "[OK] granite-3-2b" in capsys.readouterr().out
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "long_500k", "--no-flops", "--out", str(out)]) == 1
    (r,) = json.loads(out.read_text())
    assert "KeyError" in r["error"] and "[FAIL] no-such-arch" in capsys.readouterr().out


def test_mesh_counts_one_sharded_matmul():
    """Under a ``fake`` process group of 256 ranks: x (256, 64) with its rows
    on "data" times w (64, 32), (data, model) as an up-projection's rule
    places it.  DTensor gathers w over "data" (each rank's (4, 2) shard into
    (64, 2)); ``MeshCounts`` counts exactly those bytes, and the FLOPs of
    the rank's own (16, 64) x (64, 2) product.  The product runs once
    before, as ``dry_run_mesh``'s step does: DTensor's first propagation of
    an op runs it at its global shape, which the count would take."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        x = distribute_tensor(torch.ones(256, 64), mesh, (Shard(0), Replicate()))
        w = distribute_tensor(torch.ones(64, 32), mesh, (Shard(0), Shard(1)))
        x @ w
        counts = dryrun.MeshCounts(())
        with counts:
            y = x @ w
        assert y.placements == (Shard(0), Shard(1)) and y.to_local().shape == (16, 2)
        assert counts.collectives == {"all-gather": 64 * 2 * 4, "all-reduce": 0, "reduce-scatter": 0,
                                      "all-to-all": 0, "collective-permute": 0}
        assert counts.flops == 2 * 16 * 64 * 2
    finally:
        dist.destroy_process_group()


def test_dry_run_mesh_on_a_smoke_config():
    """The granite smoke's train step on the 16x16 mesh (a batch of 256,
    16 rows a data rank): one device's bytes equal what the specs place, its
    parameter count is JAX's, and the step's collectives are counted under
    JAX's five names."""
    cfg = get_smoke("granite-8b")
    r = dryrun.dry_run_mesh("granite-8b", {"seq": 16, "batch": 256, "kind": "train"}, cfg_override=cfg)
    assert set(r) == KEYS | {"mesh", "devices", "placement_bytes", "collectives", "collective_bytes_total"}
    assert r["mesh"] == "16x16" and r["devices"] == 256 and r["kind"] == "train"
    j_params = jax.eval_shape(partial(jt.init_params, j_get_smoke("granite-8b")), jax.random.PRNGKey(0))
    assert r["param_count"] == sum(x.size for x in jax.tree.leaves(j_params))
    assert r["resident_bytes"] == r["placement_bytes"] < r["param_count"] * 2 * 5  # sharded: < params + moments
    assert r["resident_bytes"] == r["param_bytes"] + r["opt_bytes"] + r["cache_bytes"] + r["input_bytes"]
    # two float32 moments a parameter, placed alike: 4x a bf16 leaf's bytes, 2x a float32 leaf's
    assert 2 * r["param_bytes"] < r["opt_bytes"] < 4 * r["param_bytes"]
    assert set(r["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"}
    assert r["collectives"]["all-gather"] > 0 and r["collective_bytes_total"] == sum(r["collectives"].values())
    assert r["peak_bytes"] >= r["resident_bytes"] and r["flops_counted"] > 0 and r["fits"]
