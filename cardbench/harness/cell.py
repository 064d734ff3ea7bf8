"""One run of one cell: set-up, the window, the trace, the check, the metrics."""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

from harness import check, guard, spec
from harness.loops import LOOPS, Driver, build_engine
from harness.traffic import Traffic
from harness.weights import draw_pair, family, model_configs, model_fields


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def card_power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float, *, device: str = "cuda",
        overrides: dict | None = None, controls: tuple = (), root=spec.ROOT) -> dict:
    """The result line's fields (``check`` last), plus ``_readings`` (every
    number the check read, the controls' too) for the limit-setting tools.
    ``overrides`` ({"target": {...}, "draft": {...}, "weights": {...}})
    replaces configuration fields: the CPU tests' small sizes."""
    cell = spec.load_cell(cell_name, root)
    tcfg, dcfg = model_configs(cell.config, overrides)
    guard.check("after loading the port")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fam = family(cell.config)
    weights = dict(cell.config, weights={**cell.config["weights"], **(overrides or {}).get("weights", {})})
    tp, dp = draw_pair(weights, tcfg, dcfg, seed, device)
    eng = build_engine(tcfg, tp, dcfg, dp, cell.traffic, seed)
    drv = Driver(eng, tcfg, dcfg, fam.active_params)
    traffic = Traffic(cell.traffic, tcfg.vocab, seed)
    tracer = None
    if trace:
        from harness.trace import Tracer

        tracer = Tracer(eng)

    def before_window():
        _sync(device)
        if tracer is not None:
            tracer.attach()
            tracer.start()

    rec = LOOPS[cell.traffic["loop"]](drv, traffic, cell.traffic, seconds, before_window)
    setup_s = rec.w0 - t_start
    events = tracer.stop() if tracer is not None else None
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if tracer is not None:
        rec.trace = tracer.result(events, rec.w0_ns, rec.w1_ns)
        tracer.detach()
        log(f"trace: {len(events)} device records, clock offset {rec.trace.offset_us:.1f} us, "
            f"{rec.trace.tree_calls} tree-kernel calls")
        del tracer, events
    if device == "cuda":
        log(f"card: {card_power()}")
    log(f"window: {rec.window_s:.3f} s, {rec.steps} steps, {rec.tokens} tokens, setup {setup_s:.3f} s, "
        f"peak {peak} B")
    # the program's state goes; the check's reference reads the weights (the
    # benchmark's own draw, handed to both), the prompts, the served tokens
    # and the sizes of the blocks that brought them
    del drv.eng, eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    finished = [r for r in rec.finished_in_window() if r.reason == "length"]
    reqs = check.sample(finished, int(cell.limits["requests"]), seed)
    ov = overrides or {}
    ref_t = {**model_fields(cell.config), **ov.get("target", {})}
    ref_d = {**model_fields(cell.config["draft"]), **ov.get("draft", {})}
    t_check = time.perf_counter()
    depth = int(cell.traffic["L1"]) + int(cell.traffic["L2"]) * min(1, int(cell.traffic["K"]))
    values = check.readings(tp, dp, ref_t, ref_d, fam, reqs, depth, controls)
    correct, shown = check.verdict(values, cell.limits)
    log(f"check: {len(reqs)} of {len(finished)} finished requests, {values['tokens']} served tokens, "
        f"{values['draft_matched']} of {values['draft_positions']} revealed draft guesses matched, "
        f"{time.perf_counter() - t_check:.1f} s")

    metrics = {"setup_s": setup_s} if not trace else {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m["name"] == "setup_s":
            continue
        v = spec.metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = v
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": len(rec.due_in_window()),
           "failed": sum(1 for r in rec.due_in_window() if r.reason not in (None, "length")),
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
           "device": dev}
    if trace:
        t = rec.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": sorted(([n, s] for n, s in t.by_name.items()), key=lambda x: -x[1])[:10],
                            "idle_gaps": [[n, s] for n, s in t.gaps]}
    guard.check("after the window")
    for name, v in shown.items():
        log(f"{name} {v['value']!r} limit {v['limit']!r}")
    out["check"] = shown
    out["_readings"] = values
    return out
