"""The port's distributed train step on 4 ``gloo`` ranks, on the CPU.

Each test spawns its ranks once (tests/_dist_ranks.py: they import torch
and the port only) and joins them under a hard timeout, so a hung rank
fails the test instead of hanging the suite.

  * on a (2, 2) ``("data", "model")`` and a (2, 1, 2) ``("pod", "data",
    "model")`` mesh, three float32 steps (AdamW with the clip) of the
    granite, qwen3-moe, mamba2 and recurrentgemma smokes through
    ``launch.train.make_sharded_train_step``, from JAX's parameters bridged
    into the port: every gathered leaf within 1e-5 of its own largest
    |value| of the single-process port's, every loss within 1e-5 relative
    of it, and the first loss within 1e-5 relative of JAX's ``loss_fn`` on
    the same parameters and batch;
  * ``pin`` and ``pin_moe_buffer`` place as specified and leave alone what
    they should, and a pool placed over two data ranks gathers back equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

import jax
import numpy as np
from torch.distributed.tensor import Replicate, Shard

from _dist_ranks import _flat, spawn
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as jt
from repro_torch import bridge
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.training.loop import to_device
from repro_torch.training.optim import AdamW

ARCHES = ["granite-3-2b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "recurrentgemma-2b"]
B, T, STEPS = 4, 8, 3
# AdamW's step is m / (sqrt(v) + eps): near a zero gradient its derivative
# in the gradient is up to lr / eps, so at eps 1e-8 the float32 rounding of
# a sharded sum (a zero-initialised norm scale's gradient cancels to ~1e-4)
# moves the update by ~2e-5 of the leaf after two steps; at eps 1e-3 the
# bound is 1 and the leaves hold to 1e-5
OPT = dict(lr=1e-3, eps=1e-3)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    b["labels"][:, -1] = -1
    return b


@pytest.fixture(scope="module")
def cases():
    """Per arch: JAX's float32 smoke parameters (numpy), STEPS batches, JAX's
    first loss, and the single-process port's losses and leaves after
    STEPS steps from the same parameters."""
    out = {}
    for arch in ARCHES:
        jcfg = j_get_smoke(arch).replace(dtype="float32")
        jp = jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
        batches = [_batch(jcfg, i) for i in range(STEPS)]
        jloss = float(jt.loss_fn(jp, jcfg, batches[0]["tokens"], batches[0]["labels"]))
        cfg = TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TConfig)})
        params = bridge.params_from_jax(jp, device="cpu")
        opt = AdamW(**OPT)
        state, step, losses = opt.init(params), tt.make_train_step(cfg, opt), []
        for b in batches:
            params, state, loss = step(params, state, to_device(b, "cpu"))
            losses.append(float(loss))
        out[arch] = (jp, batches, jloss, losses, _flat(params))
    return out


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)], ids=["data2xmodel2", "pod2xdata1xmodel2"])
def test_sharded_train_steps_match_the_port_and_jax(cases, shape, tmp_path):
    got = spawn("train_steps", 4, str(tmp_path / "init"),
                (shape, {a: c[:2] for a, c in cases.items()}, OPT), timeout=240)
    for arch, (_, _, jloss, losses, leaves) in cases.items():
        d_losses, d_leaves = got[arch]
        assert abs(d_losses[0] - jloss) <= 1e-5 * abs(jloss), (arch, d_losses[0], jloss)
        for a, b in zip(d_losses, losses):
            assert abs(a - b) <= 1e-5 * abs(b), (arch, d_losses, losses)
        assert sorted(d_leaves) == sorted(leaves)
        for path, ref in leaves.items():
            err = float(np.abs(d_leaves[path] - ref).max())
            assert err <= 1e-5 * float(np.abs(ref).max()), (arch, path, err)


def test_pins_and_a_pool_over_two_data_ranks(tmp_path):
    r = spawn("pins_and_pool", 4, str(tmp_path / "init"), timeout=120)
    rep = (Replicate(), Replicate())
    assert r["unpinned"] == rep and r["cleared"] == rep  # nothing installed: a no-op
    assert r["pinned"] == (Shard(0), Replicate()) and r["pinned_local"] == (2, 3, 8) and r["pinned_equal"]
    assert r["odd"] == rep and r["plain"] == (4, 3)  # a batch of 3 does not divide; a plain tensor stays
    assert r["moe"] == (Shard(1), Shard(0)) and r["moe_local"] == (2, 3, 8)  # experts on model, capacity on data
    assert r["pool_dtensor"] and r["pool_local"] == (2, 2, 16, 2, 8) and r["pool_equal"]
