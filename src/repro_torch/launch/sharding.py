"""The KV pool's stream axis over a data mesh.

The counterpart of the pool half of src/repro/launch/sharding.py
(``pad_slots``, ``pool_specs``, ``pool_shardings``).  torch has no
``PartitionSpec``: a leaf's spec is the index of its stream axis, which the
data axis splits, or None where the leaf replicates.  The parameter rules
of the JAX module (``param_shardings``, ``batch_shardings``) shard weights
over a TPU pod and have no use on one card: training leaves them out
(launch/train.py), and placement across cards waits with ROADMAP queue 1
item 8b.
"""
from __future__ import annotations

import torch


def pad_slots(n_slots: int, data: int) -> int:
    """Round ``n_slots`` up to a multiple of the data axis.

    The pool's stream axis must divide the data axis exactly (``pool_specs``):
    a shard that cannot take a whole slice would have to be replicated,
    doubling its pool memory and breaking the shard-local free list, while
    idle rows only cost padding lanes."""
    if n_slots < 1 or data < 1:
        raise ValueError(f"n_slots {n_slots} and data {data} must be >= 1")
    return -(-n_slots // data) * data


def pool_specs(mesh_axes: dict, cache: dict) -> dict:
    """The stream axis of every leaf of a per-stream cache pool
    (models/cache.py), or None for a leaf that replicates.

    The stream axis: attention k/v axis 1, pos/len/block_tbl axis 0,
    state/conv/tail_* axis 1, the hybrid's rec_* axis 2.  A paged arena
    ((L, NBLK + 1, block, Hkv, hd)) has no stream axis and replicates: the
    sharded engine gives every shard a private arena and free list instead.
    Unlike a parameter rule, the stream axis is never dropped: a pool whose
    ``n_slots`` does not divide the data axis is an error (pad it with
    ``pad_slots``)."""
    if "data" not in mesh_axes:
        raise ValueError("pool sharding needs a mesh with a 'data' axis")
    data = int(mesh_axes["data"])

    def stream(t: torch.Tensor, axis: int) -> int:
        if t.shape[axis] % data:
            raise ValueError(f"KV-pool stream axis of size {t.shape[axis]} does not divide the mesh data "
                             f"axis ({data}): pad n_slots with launch.sharding.pad_slots() instead of "
                             f"replicating a pool shard")
        return axis

    out: dict = {}
    for key, val in cache.items():
        if key == "attn":
            a = {"pos": stream(val["pos"], 0) if val["pos"].dim() == 2 else None,
                 "len": stream(val["len"], 0) if val["len"].dim() == 1 else None}
            if "block_tbl" in val:
                a["k"] = a["v"] = None
                a["block_tbl"] = stream(val["block_tbl"], 0)
            else:
                a["k"], a["v"] = stream(val["k"], 1), stream(val["v"], 1)
            out[key] = a
        elif key in ("rec_state", "rec_conv"):
            out[key] = stream(val, 2)
        elif key in ("state", "conv", "tail_state", "tail_conv", "cross_k", "cross_v"):
            out[key] = stream(val, 1)
        elif key == "len":
            out[key] = stream(val, 0) if val.dim() == 1 else None
        else:
            out[key] = None
    return out


def pool_shardings(mesh, cache: dict) -> dict:
    """Place a cache pool on one shard's device: every leaf moved to
    ``mesh`` (a ``torch.device``, or a sequence of one).

    JAX's other form, one engine given a multi-device data mesh, splits ONE
    pool's stream axis over several devices SPMD-style.  torch has no
    ``NamedSharding`` to carry that, and no machine of this round has two
    cards to run it: a mesh of several devices raises (ROADMAP queue 1 item
    8b, one pool over several devices)."""
    devices = [mesh] if isinstance(mesh, (str, torch.device)) else list(mesh)
    if len(devices) != 1:
        raise NotImplementedError(
            f"one pool over {len(devices)} devices is not ported: torch has no NamedSharding to split a "
            f"pool's stream axis (ROADMAP queue 1 item 8b); split the pool into slot shards with "
            f"ShardedBatchedSpeculativeEngine instead")
    dev = torch.device(devices[0])

    def place(tree: dict) -> dict:
        return {k: place(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    return place(cache)
