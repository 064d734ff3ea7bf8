"""The port's production-mesh rules (launch/mesh.py, launch/sharding.py,
models/act_sharding.py) against the JAX package, on the CPU.

JAX's rules run on ``jax.sharding.AbstractMesh`` (no devices), and
``NamedSharding.shard_shape`` gives each leaf's per-device shape: the oracle
for the port's specs, read through ``launch.sharding.local_shape``.

  * for all 10 configs, on the 16x16 and 2x16x16 meshes, in both modes:
    every parameter leaf (``param_shardings``) and every AdamW moment
    (``opt_shardings``) has JAX's per-device shape;
  * the batch of each train shape (``batch_shardings``) and the cache of
    each prefill and decode shape (``cache_shardings``, ``batch_sharded`` as
    JAX's dry run sets it) too;
  * a dropped axis is logged once per param class, as in
    ``tests/test_sharding.py::test_divisibility_drop_logs_once``;
  * ``placements`` of a tuple axis is ``Shard`` on each of its mesh dims;
  * under a ``fake`` process group of 4 ranks: ``pool_shardings`` over a
    4-rank data mesh places each pool leaf's stream axis, and ``pin`` and
    ``pin_moe_buffer`` change nothing while nothing is installed;
  * ``make_production_mesh`` refuses a process group of the wrong size.
"""
import logging
from functools import lru_cache, partial

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # shape-only work; parallel test workers share the cores

import jax
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.configs import get_config as j_get_config
from repro.launch import sharding as jsh
from repro.launch import shapes as jshapes
from repro.models import transformer as jt
from repro.training.optim import AdamW as JAdamW
from repro_torch.configs import get_config, list_arches
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import shapes as tshapes
from repro_torch.models import act_sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache, init_params

ARCHES = list_arches()
MESHES = {"16x16": False, "2x16x16": True}


def _abstract(multi_pod: bool) -> AbstractMesh:
    axes = tmesh.production_mesh_shape(multi_pod)
    return AbstractMesh(tuple(axes.values()), tuple(axes))


def _jax_shard_shapes(shardings, shapes) -> dict:
    """{path: per-device shape} of a pytree of NamedShardings over shapes."""
    flat_sh = jax.tree_util.tree_flatten_with_path(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    return {_path(p): tuple(sh.shard_shape(flat[p].shape)) for p, sh in flat_sh}


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _port_shard_shapes(specs, tree, axes, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _port_shard_shapes(specs[key], tree[key], axes, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tsh.local_shape(tuple(tree.shape), axes, specs)}


@lru_cache(maxsize=None)
def _params(arch):
    j_params = jax.eval_shape(partial(jt.init_params, j_get_config(arch)), jax.random.PRNGKey(0))
    with FakeTensorMode():
        params = init_params(get_config(arch), torch.Generator().manual_seed(0))
    return j_params, params


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHES)
def test_param_and_opt_shards_match_jax(arch, mesh, mode):
    j_params, params = _params(arch)
    jm, axes = _abstract(MESHES[mesh]), tmesh.production_mesh_shape(MESHES[mesh])
    j_sh = jsh.param_shardings(jm, j_params, j_get_config(arch), mode=mode)
    specs = tsh.param_shardings(axes, params, get_config(arch), mode=mode)
    want = _jax_shard_shapes(j_sh, j_params)
    assert _port_shard_shapes(specs, params, axes) == want
    if mode == "train":
        j_opt = jsh.opt_shardings(jm, j_sh, jax.eval_shape(JAdamW().init, j_params))
        o_specs = tsh.opt_shardings(axes, specs)
        for moment in ("mu", "nu"):
            assert _port_shard_shapes(o_specs[moment], params, axes) == \
                _jax_shard_shapes(getattr(j_opt, moment), j_params) == want
        assert j_opt.step.spec == () and o_specs["step"] == ()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHES)
def test_batch_and_cache_shards_match_jax(arch, mesh):
    jm, axes = _abstract(MESHES[mesh]), tmesh.production_mesh_shape(MESHES[mesh])
    for shape in tshapes.SHAPES:
        j_kind, j_kw, _ = jshapes.input_specs(j_get_config(arch), shape)
        kind, kw, _ = tshapes.input_specs(get_config(arch), shape)
        if kind == "train":
            got = _port_shard_shapes(tsh.batch_shardings(axes, kw["batch"]), kw["batch"], axes)
            assert got == _jax_shard_shapes(jsh.batch_shardings(jm, j_kw["batch"]), j_kw["batch"]), shape
        else:
            sharded = tshapes.SHAPES[shape]["batch"] > 1
            got = _port_shard_shapes(tsh.cache_shardings(axes, kw["cache"], batch_sharded=sharded), kw["cache"], axes)
            want = _jax_shard_shapes(jsh.cache_shardings(jm, j_kw["cache"], batch_sharded=sharded), j_kw["cache"])
            assert got == want, shape


def test_divisibility_drop_logs_once(caplog):
    tsh._logged_drops.clear()
    axes = {"data": 16, "model": 16}
    with caplog.at_level(logging.WARNING, logger="repro_torch.launch.sharding"):
        assert tsh._spec_for("embed", (49155, 512), axes) == (None, "data")
        assert tsh._spec_for("embed", (49155, 512), axes) == (None, "data")
    drops = [r for r in caplog.records if "drops axis" in r.getMessage()]
    assert len(drops) == 1, [r.getMessage() for r in caplog.records]


def test_placements_of_a_spec():
    axes = tmesh.production_mesh_shape(True)
    assert tsh.placements(axes, (("pod", "data"), None)) == (Shard(0), Shard(0), Replicate())
    assert tsh.placements(axes, ("model", "data")) == (Replicate(), Shard(1), Shard(0))
    assert tsh.placements(axes, (None, None)) == (Replicate(),) * 3
    assert tsh.local_shape((64, 32), axes, (("pod", "data"), "model")) == (2, 2)
    assert tmesh.data_axes(axes) == ("pod", "data") and tmesh.axis_size(axes, "model") == 16
    assert tmesh.data_axes({"data": 16, "model": 16}) == ("data",) and tmesh.axis_size({"data": 4}, "pod") == 1


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_pool_placement_and_idle_pins(fake_group):
    mesh = tmesh.make_data_mesh(4, device_type="cpu")
    cfg = ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, dtype="float32")
    ring = init_cache(cfg, 8, 16, "cpu", per_stream=True)
    placed = tsh.pool_shardings(mesh, ring)
    for name, axis in (("k", 1), ("v", 1), ("pos", 0), ("len", 0)):
        leaf = placed["attn"][name]
        assert isinstance(leaf, DTensor) and leaf.placements == (Shard(axis),), name
        want = list(ring["attn"][name].shape)
        want[axis] //= 4
        assert list(leaf.to_local().shape) == want, name
    with pytest.raises(ValueError, match="pad_slots"):  # 6 streams do not divide 4 ranks
        tsh.pool_shardings(mesh, init_cache(cfg, 6, 16, "cpu", per_stream=True))
    # nothing installed: the pins change nothing, DTensor or not
    x = distribute_tensor(torch.ones(8, 3, 4), mesh, (Replicate(),))
    plain = torch.ones(8, 3, 4)
    assert act_sharding.pin(x) is x and act_sharding.pin(plain) is plain
    assert act_sharding.pin_moe_buffer(x) is x and act_sharding.pin_moe_buffer(plain) is plain
    with pytest.raises(RuntimeError, match="world size 4"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="8-shard data mesh needs 8 ranks"):
        tmesh.make_data_mesh(8, device_type="cpu")
