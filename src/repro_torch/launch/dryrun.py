"""Dry run: build every (architecture x input shape) with fake tensors and
count what one step would hold and compute.  The counterpart of
src/repro/launch/dryrun.py.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-flops --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8   # every step run, 8 processes

Under ``torch._subclasses.fake_tensor.FakeTensorMode`` the parameters (and,
for a train step, AdamW's state), the cache and the inputs of launch/shapes.py
are built with their real shapes and dtypes and nothing allocated; then the
step runs on them inside ``torch.utils.flop_counter.FlopCounterMode`` and a
mode that tracks the bytes of live storages.  It uses no device and needs
no ``--device``: fake CPU tensors take the plain attention of kernels/ops.py,
so ``flops_counted`` is the plain path's (the full S x S logits of a
prefill, the dropless MoE dispatch at the call's token count), which is why
``flops_model`` (2 or 6 x active parameters x tokens) stands beside it.

Left out, from the JAX module: ``--multi-pod``, ``make_production_mesh``,
``param_shardings``, ``opt_shardings``, ``cache_shardings``,
``batch_shardings`` and ``models/act_sharding.py`` shard a step over a TPU
pod, and ``collective_bytes`` parses XLA's HLO for its collectives.  One
card has no mesh and no collectives: they wait with ROADMAP queue 1 item 8b.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.configs import get_config, list_arches
from repro_torch.launch.shapes import SHAPES, input_specs, shape_spec
from repro_torch.models.transformer import forward, init_params, make_train_step
from repro_torch.training.optim import AdamW

# what torch.cuda.get_device_properties(0).total_memory reports on an
# NVIDIA H100 80GB HBM3 (chip_smoke.py phase 11 checks it on the card)
H100_BYTES = 85_017_493_504


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree))


class PeakBytes(TorchDispatchMode):
    """The high-water mark of the bytes of live storages: those of
    ``resident`` at the start, plus each new storage an op returns, minus
    each storage once it is freed (its weak reference expired)."""

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
            storage = t.untyped_storage()
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
        out = func(*args, **(kwargs or {}))
        self._add(tree_leaves(out))
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


def _run(entry) -> tuple[str, dict]:
    arch, shape, count_flops = entry
    try:  # a failed entry is recorded, and main's exit code says so
        return "OK", dry_run_one(arch, shape, count_flops=count_flops)
    except Exception as e:  # noqa: BLE001
        return "FAIL", {"arch": arch, "shape": shape_spec(shape)[0], "error": f"{type(e).__name__}: {e}"}


def dry_run_table(entries, jobs: int = 1):
    """Yields (status "OK" or "FAIL", result) of each (arch, shape,
    count_flops) of ``entries``, in order: in this process, or over
    ``jobs`` worker processes (each entry is independent, host-bound Python
    work; the workers are spawned, so they never share a CUDA context)."""
    if jobs <= 1:
        yield from map(_run, entries)
        return
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield from pool.map(_run, entries)


def _line(status: str, r: dict) -> str:
    if status == "FAIL":
        return f"[FAIL] {r['arch']:26s} {r['shape']:12s} {r['error'][:160]}"
    flops = "-" if r["flops_counted"] is None else f"{r['flops_counted']:.3e}"
    peak = "-" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2**30:.2f}"
    return (f"[OK] {r['arch']:26s} {r['shape']:12s} {r['kind']:7s} params {r['param_count'] / 1e9:.2f} B "
            f"resident {r['resident_bytes'] / 2**30:.2f} GiB peak {peak} GiB fits {r['fits']} "
            f"flops counted {flops} model {r['flops_model']:.3e} ({r['seconds']:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="one registered arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES), help="one shape (default: all)")
    ap.add_argument("--all", action="store_true", help="every arch x every shape")
    ap.add_argument("--no-flops", action="store_true", help="build only: do not run the step")
    ap.add_argument("--out", default=None, help="write the results there as a JSON list")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes (each entry runs in one)")
    args = ap.parse_args(argv)

    arches = list_arches() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    entries = [(arch, shape, not args.no_flops) for arch in arches for shape in shapes]
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
