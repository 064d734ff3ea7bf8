"""Activation sharding constraints (ZeRO-3/FSDP semantics).

The counterpart of src/repro/models/act_sharding.py.  Sharding weights'
d_in on the data axis is only half of FSDP: without activation constraints
a partitioner may satisfy a contraction by replicating the activations over
the batch instead of gathering the weight.  Pinning every block input to a
batch-sharded layout makes DTensor's sharding propagation gather the weights
instead: the ZeRO-3 schedule.

The launch layer installs the constraint (a ``DeviceMesh`` and its batch
axes); model code calls ``pin`` on block inputs.  A no-op when nothing is
installed (one device: the engines, single-process training, the tests) and
on anything but a DTensor.  ``pin`` is JAX's ``with_sharding_constraint``
as a ``redistribute``.

The rest are the model's DTensor paths where DTensor's own sharding
propagation has no rule for an op, or picks a placement that fake tensors
cannot place, or searches too long on a 3-D mesh; XLA's partitioner makes
such choices on its own.  On plain tensors each is the plain call, so the
single-device path is unchanged: ``tensor_parallel`` (the attention and
SwiGLU of a pass without a cache, Megatron's column- then row-parallel
pair), ``rows_gathered`` (the embedding lookup, the LM head, the
cross-attention, the SSD and RG-LRU mixers), ``replicated`` (the MoE
layer, a serve step's position table), ``ring_attention`` (a serve step's
ring-cache layer), ``rows`` and ``split_heads`` (layouts before the serve
steps' attention projections and their reshapes).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._pytree import tree_flatten, tree_map

_STATE: dict = {"mesh": None, "axes": None}


def install(mesh, axes) -> None:
    _STATE["mesh"] = mesh
    _STATE["axes"] = tuple(axes)


def clear() -> None:
    _STATE["mesh"] = None
    _STATE["axes"] = None


@contextmanager
def activation_sharding(mesh, axes):
    install(mesh, axes)
    try:
        yield
    finally:
        clear()


def _size(mesh, axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def pin(x):
    """A (B, ...) DTensor activation redistributed to ``Shard(0)`` on the
    installed batch axes and ``Replicate()`` on the others, when the batch
    divides; anything else unchanged."""
    mesh, axes = _STATE["mesh"], _STATE["axes"]
    if mesh is None or not isinstance(x, DTensor) or x.dim() < 2 or x.shape[0] % _size(mesh, axes):
        return x
    return x.redistribute(mesh, tuple(Shard(0) if name in axes else Replicate() for name in mesh.mesh_dim_names))


def pin_moe_buffer(buf):
    """An (E, C, D) expert-capacity DTensor buffer in 2D: experts -> model
    (expert parallel), capacity -> the batch axes, each where it divides.
    No model calls it, as in JAX (src/repro/models/moe.py records why: the
    combine's gather from a capacity-sharded buffer forces a full reshard)."""
    mesh, axes = _STATE["mesh"], _STATE["axes"]
    if mesh is None or not isinstance(buf, DTensor) or buf.dim() != 3:
        return buf
    E, C, _ = buf.shape
    names = mesh.mesh_dim_names
    m_ok = "model" in names and E % _size(mesh, ("model",)) == 0
    c_ok = C % _size(mesh, axes) == 0
    pl = tuple(Shard(0) if name == "model" and m_ok else Shard(1) if name in axes and c_ok else Replicate()
               for name in names)
    return buf.redistribute(mesh, pl)


def replicated(fn, *args):
    """``fn(*args)`` where some tensor of ``args`` (a pytree) is a DTensor:
    each DTensor gathered whole (``Replicate`` on every mesh dim), ``fn`` run
    on the local values, every tensor it returns wrapped back as a
    replicated DTensor.  Both conversions are differentiable, and each rank
    computes the whole function, so its gradients are whole too.  The
    fallback for an op with no DTensor sharding rule; without a DTensor
    among ``args`` it is ``fn(*args)``."""
    dts = [t for t in tree_flatten(args)[0] if isinstance(t, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rep = (Replicate(),) * mesh.ndim
    local = tree_map(lambda t: t.redistribute(mesh, rep).to_local() if isinstance(t, DTensor) else t, args)
    return tree_map(lambda t: DTensor.from_local(t, mesh, rep, run_check=False) if isinstance(t, torch.Tensor)
                    else t, fn(*local))


def _rows(mesh, B: int, model_dim: int | None = None) -> tuple:
    """Placements of a (B, ...) activation whose rows split over every mesh
    axis but ``"model"`` where B divides (else replicated), and whose dim
    ``model_dim`` (None: none) splits over ``"model"``."""
    names = mesh.mesh_dim_names
    rows = B % _size(mesh, [n for n in names if n != "model"]) == 0
    return tuple((Replicate() if model_dim is None else Shard(model_dim)) if n == "model"
                 else Shard(0) if rows else Replicate() for n in names)


def _model_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def rows(x):
    """A (B, ...) DTensor redistributed to ``_rows`` (replicated on
    ``"model"``); anything else unchanged.  The input of the serve steps'
    attention projections, which DTensor's propagation places: it may leave
    an activation split on its time axis over ``"model"`` (a partial sum
    reduce-scattered), and a product then flattens (B, T) into a strided
    split that fake tensors cannot place."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, _rows(x.device_mesh, x.shape[0]))


def split_heads(x, n: int, d: int):
    """(B, T, n * d) -> (B, T, n, d).  A DTensor first takes ``_rows`` with
    its last dim split over ``"model"`` only in whole heads (where n
    divides; else replicated there): DTensor cannot unflatten a dim that is
    split unevenly."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        m = _model_size(mesh)
        x = x.redistribute(mesh, _rows(mesh, x.shape[0], 2 if m > 1 and n % m == 0 else None))
    return x.reshape(*x.shape[:-1], n, d)


def rows_gathered(fn, x, *weights):
    """``fn(*x, *weights)`` (``x`` a (B, ...) activation, or a tuple of
    them, each a tensor, a dict of tensors or None) on DTensors as ZeRO-3
    runs it: each rank takes its rows of every activation (``_rows``, by
    the first's B) and every weight whole (gathered), and every tensor
    ``fn`` returns is wrapped back with those placements.  Each weight's
    gradient is a part of a sum over the ranks of the other rows
    (``Partial`` there).  Without a DTensor first activation it is
    ``fn(*x, *weights)``."""
    xs = x if isinstance(x, tuple) else (x,)
    if not isinstance(xs[0], DTensor):
        return fn(*xs, *weights)
    mesh = xs[0].device_mesh
    pl = _rows(mesh, xs[0].shape[0])
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    rep = (Replicate(),) * mesh.ndim
    ws = [w.redistribute(mesh, rep).to_local(grad_placements=grad) for w in weights]
    local = tree_map(lambda a: a.redistribute(mesh, pl).to_local() if isinstance(a, DTensor) else a, xs)
    return tree_map(lambda t: DTensor.from_local(t, mesh, pl, run_check=False) if isinstance(t, torch.Tensor)
                    else t, fn(*local, *ws))


def tensor_parallel(fn, x, split_last=(), split_first=(), whole=(), *, split: bool):
    """``fn(x, *split_last, *split_first, *whole, rank)`` on DTensors as
    Megatron runs a column- then row-parallel pair: each rank takes its rows
    of ``x`` (``_rows``) and, where ``split``, its slice over ``"model"`` of
    each weight of ``split_last`` (by its last dim) and of ``split_first``
    (by its first), every weight gathered over the other axes; ``whole``
    weights it takes entire.  ``rank`` is the rank's index on ``"model"``
    (so ``fn`` can pick its share of a ``whole`` weight).  Where
    ``split``, what ``fn`` returns is the rank's part of a sum over
    ``"model"`` (``Partial``), and so is each gradient that more than one
    model rank feeds: ``x``'s and a ``whole`` weight's; every weight's
    gradient is a part of a sum over the other rows' ranks too.  DTensor's
    own propagation of such products' backward over a 2 x 16 x 16 mesh
    strides the flattened (B, T) dim, which fake tensors cannot place."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    pl = _rows(mesh, x.shape[0])
    rows_grad = tuple(Partial() if r.is_shard() else Replicate() for r in pl)

    def local(w, d):  # d: the dim split over "model", or None
        fwd = tuple((Shard(d) if d is not None else Replicate()) if n == "model" else Replicate() for n in names)
        grad = tuple((fwd[i] if d is not None else Partial() if split else Replicate()) if n == "model"
                     else rows_grad[i] for i, n in enumerate(names))
        return w.redistribute(mesh, fwd).to_local(grad_placements=grad)

    ws = ([local(w, w.dim() - 1 if split else None) for w in split_last]
          + [local(w, 0 if split else None) for w in split_first] + [local(w, None) for w in whole])
    on_model = lambda p: tuple(Partial() if n == "model" and split else q for n, q in zip(names, p))
    rank = mesh.get_local_rank("model") if "model" in names else 0
    y = fn(x.redistribute(mesh, pl).to_local(grad_placements=on_model(pl)), *ws, rank)
    return DTensor.from_local(y, mesh, on_model(pl), run_check=False)


def ring_attention(attend, write, q, k, v, kc, vc, slots, mask):
    """One attention layer over a ring cache on DTensors (the dry run's
    prefill and decode over a mesh): each rank takes its rows (``_rows``)
    of the new ``q``/``k``/``v`` and of the layer's cache ``kc``/``vc``
    with every slot (the serve rules split the slots over ``"model"``),
    ``write(kc, vc, k, v, slots)`` s the new entries into that copy,
    attends with ``attend(q, kc, vc, mask)``, and the written rows go back
    into ``kc``/``vc`` at their own placements.  An index_copy_ into a dim
    that DTensor splits has no rule; neither does the plain attention's
    masked einsum over a split slot axis."""
    mesh = q.device_mesh
    pl = _rows(mesh, q.shape[0])
    rep = (Replicate(),) * mesh.ndim
    loc = lambda t: t.redistribute(mesh, pl).to_local()
    whole = lambda t: t.redistribute(mesh, rep).to_local() if isinstance(t, DTensor) else t
    kl, vl = loc(kc), loc(vc)
    write(kl, vl, loc(k), loc(v), whole(slots))
    m = mask if mask.shape[0] == q.shape[0] else whole(mask)
    out = attend(loc(q), kl, vl, loc(m) if isinstance(m, DTensor) else m)
    kc.copy_(DTensor.from_local(kl, mesh, pl, run_check=False))
    vc.copy_(DTensor.from_local(vl, mesh, pl, run_check=False))
    return DTensor.from_local(out, mesh, pl, run_check=False)
