"""Serving data meshes: where each shard of the sharded engine lives.

The counterpart of ``shard_meshes`` in src/repro/launch/mesh.py.  torch has
no mesh object: a shard's "mesh" is the one ``torch.device`` its pool lives
on.  The production meshes of the JAX module (``make_production_mesh``,
``data_axes``) shard parameters over a TPU pod; they have no use on one card,
so training leaves them out (launch/train.py; ROADMAP queue 1 item 8b).
"""
from __future__ import annotations

import torch


def shard_meshes(n_shards: int, devices=None) -> list[torch.device]:
    """One device per shard, cycling ``devices``: by default every CUDA
    device of the host (``torch.cuda.device_count()``), or the CPU when
    there is none.  The sharded engine does not place its shards by it yet:
    every shard lives on the weights' device, and shards on other cards are
    ROADMAP queue 1 item 8b."""
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    if devices is None:
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no device to place the shards on")
    return [devices[i % len(devices)] for i in range(n_shards)]
