"""Dry run: build every (architecture x input shape) with fake tensors and
count what one step would hold and compute.  The counterpart of
src/repro/launch/dryrun.py.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-flops --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8   # every step run, 8 processes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --jobs 8   # the production meshes

Under ``torch._subclasses.fake_tensor.FakeTensorMode`` the parameters (and,
for a train step, AdamW's state), the cache and the inputs of launch/shapes.py
are built with their real shapes and dtypes and nothing allocated; then the
step runs on them inside ``torch.utils.flop_counter.FlopCounterMode`` and a
mode that tracks the bytes of live storages.  It uses no device and needs
no ``--device``: fake CPU tensors take the plain attention of kernels/ops.py,
so ``flops_counted`` is the plain path's (the full S x S logits of a
prefill, the dropless MoE dispatch at the call's token count), which is why
``flops_model`` (2 or 6 x active parameters x tokens) stands beside it.

That is the one-card table (``--multi-pod one-card``, the default): does an
entry fit one H100.  ``--multi-pod no|yes|both`` is JAX's ``lower_one(...,
multi_pod=...)``: ``dry_run_mesh`` places the entry on the 16x16 and/or
2x16x16 production mesh (launch/mesh.py) of a ``fake`` process group (256
or 512 ranks in this one process, collectives that move nothing), with the
placements of launch/sharding.py and the activation pins of
models/act_sharding.py, and runs the step as DTensors of fake tensors: the
train step is launch/train.py's ``make_sharded_train_step``.  Every count is
one device's, read from the local shards: the resident bytes (held equal to
what the specs place, ``placement_bytes``), the peak of live local bytes,
the FLOPs of the local ops, and ``collectives``: the output bytes of each
functional collective the step issues, under JAX's five HLO names (the
counterpart of its ``collective_bytes``).  The step runs twice and is
counted the second time: on its first run DTensor's sharding propagation
also runs each new op once at its global shape, which the counts would take
for the device's work.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.configs import get_config, list_arches
from repro_torch.launch.mesh import data_axes, make_production_mesh, production_mesh_shape
from repro_torch.launch.shapes import SHAPES, input_specs, shape_spec
from repro_torch.launch.sharding import (batch_shardings, batch_spec, cache_shardings, distribute, local_shape,
                                         opt_shardings, param_shardings)
from repro_torch.launch.train import make_sharded_train_step
from repro_torch.models.act_sharding import activation_sharding
from repro_torch.models.transformer import forward, init_params, make_train_step
from repro_torch.training.optim import AdamW

# what torch.cuda.get_device_properties(0).total_memory reports on an
# NVIDIA H100 80GB HBM3 (chip_smoke.py phase 11 checks it on the card)
H100_BYTES = 85_017_493_504


# JAX's HLO names of the functional collectives a DTensor step issues
COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
# the functional collectives' own helpers, which move nothing
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(tree) -> int:
    """The bytes of every tensor leaf, a DTensor's local shard only."""
    return sum(_local(t).nbytes for t in tree_leaves(tree))


class PeakBytes(TorchDispatchMode):
    """The high-water mark of the bytes of live storages: those of
    ``resident`` at the start, plus each new storage an op returns, minus
    each storage once it is freed (its weak reference expired).  An op on
    DTensors is handed on (``NotImplemented``) to DTensor's dispatch, whose
    ops on the local shards come back here: the storages are one rank's."""

    def __init__(self, resident):
        super().__init__()
        self.live: dict[int, tuple[StorageWeakRef, int]] = {}
        self.now = self.peak = 0
        self._add(tree_leaves(resident))

    def _add(self, outs):
        swept = False
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            storage = _local(t).untyped_storage()
            ref = StorageWeakRef(storage)
            if ref.cdata in self.live:  # a view of a live storage (a held weak reference
                continue                # keeps a freed storage's address from reuse)
            if not swept:  # a new storage: first drop the ones freed since the last
                self._sweep()
                swept = True
            self.live[ref.cdata] = (ref, storage.nbytes())
            self.now += storage.nbytes()
        self.peak = max(self.peak, self.now)

    def _sweep(self):
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.now -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self._add(tree_leaves(out))
        return out


class MeshCounts(PeakBytes):
    """``PeakBytes`` of one rank, plus the FLOPs of its local ops (torch's
    ``flop_registry``, as ``FlopCounterMode`` counts them) and the output
    bytes of each functional collective (``COLLECTIVES``)."""

    def __init__(self, resident):
        super().__init__(resident)
        self.flops = 0
        self.collectives = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                          "collective-permute"), 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._add(tree_leaves(out))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif func.namespace in ("_c10d_functional", "c10d") and packet.__name__ not in _NOT_COLLECTIVES:
            name = packet.__name__.removesuffix("_").removesuffix("_coalesced")
            if name not in COLLECTIVES:
                raise NotImplementedError(f"a collective the dry run does not count: {func}")
            self.collectives[COLLECTIVES[name]] += sum(t.nbytes for t in tree_leaves(out))
        return out


def build_step(cfg, kind: str):
    """(step, optimizer or None): the train step with AdamW(lr=1e-4), a
    prefill returning the last logits and the filled cache, or a serve step
    of one new token."""
    if kind == "train":
        opt = AdamW(lr=1e-4)
        return make_train_step(cfg, opt), opt
    if kind == "prefill":
        def prefill(params, cache, tokens, enc_embeds=None, embeds=None):
            logits, new_cache, _ = forward(params, cfg, tokens, mode="full", cache=cache,
                                           enc_embeds=enc_embeds, embeds=embeds)
            return logits[:, -1], new_cache
        return prefill, None

    def serve_step(params, cache, tokens):
        logits, new_cache, _ = forward(params, cfg, tokens, mode="decode", cache=cache)
        return logits, new_cache
    return serve_step, None


def dry_run_one(arch: str, shape, *, count_flops: bool = True, cfg_override=None) -> dict:
    """The counterpart of JAX's ``lower_one``: one (arch x shape) built on
    fake tensors.  Returns the byte counts of the parameters, AdamW's state
    (train), the cache (prefill, decode) and the inputs, their sum
    ``resident_bytes``, ``flops_model`` and, when ``count_flops``, the step
    run once: ``flops_counted`` (FlopCounterMode) and ``peak_bytes`` (the
    high-water mark of live storages, the counterpart of XLA's argument +
    temp bytes); without it those two are None and nothing runs but the
    fake init.  ``fits``: ``peak_bytes`` (else ``resident_bytes``) <=
    H100_BYTES.  ``shape`` is a name of ``SHAPES`` or a dict (launch/shapes.py).

    cfg_override: replace the registered config (a reduced-depth variant
    goes through the same path)."""
    t0 = time.perf_counter()
    name, spec = shape_spec(shape)
    cfg0 = cfg_override if cfg_override is not None else get_config(arch)
    mode = FakeTensorMode()
    kind, kw, cfg = input_specs(cfg0, shape, fake_mode=mode)
    step, opt = build_step(cfg, kind)
    with mode:
        params = init_params(cfg, torch.Generator().manual_seed(0))
        opt_state = opt.init(params) if opt is not None else None
    if kind == "train":
        args, cache, inputs = (params, opt_state, kw["batch"]), {}, kw["batch"]
    else:
        cache = kw["cache"]
        inputs = {k: v for k, v in kw.items() if k != "cache"}
        args = (params, cache, *(inputs[k] for k in ("tokens", "enc_embeds", "embeds") if k in inputs))
    res = {"arch": arch, "shape": name, "kind": kind,
           "param_count": sum(t.numel() for t in tree_leaves(params)),
           "param_bytes": _nbytes(params),
           "opt_bytes": _nbytes((opt_state.mu, opt_state.nu)) if opt_state is not None else 0,
           "cache_bytes": _nbytes(cache), "input_bytes": _nbytes(inputs)}
    res["resident_bytes"] = res["param_bytes"] + res["opt_bytes"] + res["cache_bytes"] + res["input_bytes"]
    # active parameters: the registered count less the experts a token does not reach
    active = res["param_count"] - (cfg.param_count() - cfg.active_param_count())
    tokens = spec["batch"] * (1 if kind == "decode" else spec["seq"])
    res["flops_model"] = (6 if kind == "train" else 2) * active * tokens
    res["flops_counted"] = res["peak_bytes"] = None
    if count_flops:
        peak = PeakBytes(args)
        counter = FlopCounterMode(display=False)
        with mode, counter, peak:
            if kind == "train":
                step(*args)
            elif kind == "prefill":
                step(params, cache, inputs["tokens"], enc_embeds=inputs.get("enc_embeds"),
                     embeds=inputs.get("embeds"))
            else:
                step(params, cache, inputs["tokens"])
        res["flops_counted"] = counter.get_total_flops()
        res["peak_bytes"] = peak.peak
    res["fits"] = (res["peak_bytes"] if count_flops else res["resident_bytes"]) <= H100_BYTES
    res["seconds"] = time.perf_counter() - t0
    return res


def _fake_process_group(world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _bytes_placed(tree, specs, mesh) -> int:
    """The bytes one rank holds of ``tree`` by the arithmetic of its specs
    (``local_shape``): what ``_nbytes`` of the placed tree must equal."""
    if isinstance(tree, dict):
        return sum(_bytes_placed(v, specs[k], mesh) for k, v in tree.items())
    return math.prod(local_shape(tree.shape, mesh, specs)) * tree.element_size()


def dry_run_mesh(arch: str, shape, *, multi_pod: bool = False, count_flops: bool = True,
                 cfg_override=None) -> dict:
    """JAX's ``lower_one(arch, shape, multi_pod=...)``: one (arch x shape)
    on the production mesh, in a ``fake`` process group of 256 (512) ranks
    that this call makes and ends (so none may exist already).  The fake
    parameters (mode "serve" for a decode step, else "train"), AdamW's
    state, the cache and the inputs are placed by launch/sharding.py, the
    activation pins installed on the data axes, and with ``count_flops``
    the step runs (twice; the second run counted, see the module's
    docstring).  Every byte, FLOP and collective is one device's.  Returns
    the keys of ``dry_run_one`` (``flops_model`` the device's even share)
    plus ``mesh``, ``devices``, ``placement_bytes``, ``collectives`` (JAX's
    five HLO names) and ``collective_bytes_total``."""
    t0 = time.perf_counter()
    name, spec = shape_spec(shape)
    axes = production_mesh_shape(multi_pod)
    devices = math.prod(axes.values())
    _fake_process_group(devices)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cfg0 = cfg_override if cfg_override is not None else get_config(arch)
        mode = FakeTensorMode()
        kind, kw, cfg = input_specs(cfg0, shape, fake_mode=mode)
        step, opt = build_step(cfg, kind)
        with mode:
            params = init_params(cfg, torch.Generator().manual_seed(0))
        param_count = sum(t.numel() for t in tree_leaves(params))
        p_sh = param_shardings(mesh, params, cfg, mode="serve" if kind == "decode" else "train")
        placed = _bytes_placed(params, p_sh, mesh)
        cache, opt_state = {}, None
        with mode:
            params = distribute(params, mesh, p_sh)
            if kind == "train":
                opt_state = opt.init(params)
                o_sh = opt_shardings(mesh, p_sh)
                placed += _bytes_placed(opt_state.mu, o_sh["mu"], mesh) + _bytes_placed(opt_state.nu, o_sh["nu"], mesh)
                inputs = kw["batch"]
                in_sh = batch_shardings(mesh, inputs)
                step = make_sharded_train_step(cfg, opt, mesh)
            else:
                cache = kw["cache"]
                c_sh = cache_shardings(mesh, cache, batch_sharded=spec["batch"] > 1)
                placed += _bytes_placed(cache, c_sh, mesh)
                cache = distribute(cache, mesh, c_sh)
                inputs = {k: v for k, v in kw.items() if k != "cache"}
                lead = batch_spec(mesh) if spec["batch"] % math.prod(axes[a] for a in data_axes(mesh)) == 0 \
                    else (None,)
                in_sh = {k: lead + (None,) * (v.dim() - 1) for k, v in inputs.items()}
            placed += _bytes_placed(inputs, in_sh, mesh)
            inputs = distribute(inputs, mesh, in_sh)
        args = (params, opt_state, inputs) if kind == "train" else \
            (params, cache, *(inputs[k] for k in ("tokens", "enc_embeds", "embeds") if k in inputs))
        res = {"arch": arch, "shape": name, "kind": kind, "mesh": "x".join(map(str, axes.values())),
               "devices": devices, "param_count": param_count, "param_bytes": _nbytes(params),
               "opt_bytes": _nbytes((opt_state.mu, opt_state.nu)) if opt_state is not None else 0,
               "cache_bytes": _nbytes(cache), "input_bytes": _nbytes(inputs), "placement_bytes": placed}
        res["resident_bytes"] = res["param_bytes"] + res["opt_bytes"] + res["cache_bytes"] + res["input_bytes"]
        active = param_count - (cfg.param_count() - cfg.active_param_count())
        tokens = spec["batch"] * (1 if kind == "decode" else spec["seq"])
        res["flops_model"] = (6 if kind == "train" else 2) * active * tokens // devices
        res["flops_counted"] = res["peak_bytes"] = res["collectives"] = res["collective_bytes_total"] = None
        if count_flops:
            with mode, implicit_replication(), activation_sharding(mesh, data_axes(mesh)):
                step(*args)  # fills DTensor's propagation caches
            counts = MeshCounts(args)
            with mode, implicit_replication(), activation_sharding(mesh, data_axes(mesh)), counts:
                step(*args)
            res.update(flops_counted=counts.flops, peak_bytes=counts.peak, collectives=counts.collectives,
                       collective_bytes_total=sum(counts.collectives.values()))
        res["fits"] = (res["peak_bytes"] if count_flops else res["resident_bytes"]) <= H100_BYTES
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    return res


def _run(entry) -> tuple[str, dict]:
    arch, shape, count_flops, mesh, *override = entry
    try:  # a failed entry is recorded, and main's exit code says so
        if mesh is None:
            return "OK", dry_run_one(arch, shape, count_flops=count_flops,
                                     cfg_override=override[0] if override else None)
        return "OK", dry_run_mesh(arch, shape, multi_pod=mesh, count_flops=count_flops)
    except Exception as e:  # noqa: BLE001
        r = {"arch": arch, "shape": shape_spec(shape)[0], "error": f"{type(e).__name__}: {e}"}
        if mesh is not None:
            r["mesh"] = "x".join(map(str, production_mesh_shape(mesh).values()))
        return "FAIL", r


def dry_run_table(entries, jobs: int = 1):
    """Yields (status "OK" or "FAIL", result) of each (arch, shape,
    count_flops, mesh[, cfg_override]) of ``entries`` (mesh None:
    ``dry_run_one``, with ``cfg_override`` when given, else
    ``dry_run_mesh`` with ``multi_pod=mesh``), in order: in this process, or over
    ``jobs`` worker processes (each entry is independent, host-bound Python
    work; the workers are spawned, so they never share a CUDA context)."""
    if jobs <= 1:
        yield from map(_run, entries)
        return
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield from pool.map(_run, entries)


def _line(status: str, r: dict) -> str:
    mesh = f" {r['mesh']:8s}" if "mesh" in r else ""
    if status == "FAIL":
        return f"[FAIL] {r['arch']:26s} {r['shape']:12s}{mesh} {r['error'][:160]}"
    flops = "-" if r["flops_counted"] is None else f"{r['flops_counted']:.3e}"
    peak = "-" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2**30:.2f}"
    line = (f"[OK] {r['arch']:26s} {r['shape']:12s}{mesh} {r['kind']:7s} params {r['param_count'] / 1e9:.2f} B "
            f"resident {r['resident_bytes'] / 2**30:.2f} GiB peak {peak} GiB fits {r['fits']} "
            f"flops counted {flops} model {r['flops_model']:.3e}")
    if r.get("collective_bytes_total") is not None:
        line += f" collectives {r['collective_bytes_total'] / 2**30:.2f} GiB"
    return line + f" ({r['seconds']:.1f} s)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="one registered arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES), help="one shape (default: all)")
    ap.add_argument("--all", action="store_true", help="every arch x every shape")
    ap.add_argument("--no-flops", action="store_true", help="build only: do not run the step")
    ap.add_argument("--out", default=None, help="write the results there as a JSON list")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes (each entry runs in one)")
    ap.add_argument("--multi-pod", choices=["one-card", "no", "yes", "both"], default="one-card",
                    help="one-card: does each entry fit one H100 (no mesh); no / yes / both: per device on the "
                         "16x16 and/or 2x16x16 production mesh, as JAX's --multi-pod")
    args = ap.parse_args(argv)

    arches = list_arches() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"one-card": [None], "no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]
    entries = [(arch, shape, not args.no_flops, mesh) for arch in arches for shape in shapes for mesh in meshes]
    results = []
    for status, r in dry_run_table(entries, args.jobs):
        results.append(r)
        print(_line(status, r), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    bad = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(bad)}/{len(results)} dry runs OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
