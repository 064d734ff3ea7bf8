#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json-dir DIR]   # from the root of a checkout, on a machine with a card

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off for float32 matmuls; builds every kernel of the
   path from src/repro_torch/kernels/csrc with nvcc (one process per source,
   all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, in float32 and bfloat16, with the tolerance stated; times
   the kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick only: the port never calls it) with CUDA
   events, a cold L2 before every launch, median of several launches; and
   the least time the card could take for the same work (bound_ms).
3. The main path at full width: granite-8b (36 layers, bf16) with its
   make_draft_cfg draft, random weights drawn on the card from seeded
   generators, served by SpeculativeEngine with specinfer at
   (K, L1, L2) = (2, 2, 2) for 2 requests x 32 new tokens, then 1 request
   with traversal.  Kernel launch counts are set to 0 just before each run
   and must equal the masked attention passes x layers just after.  The
   output is checked: tokens in the vocabulary, block efficiency within its
   range, and the full-width draft's logits on the card (kernel) against the
   same forward on the CPU (plain versions) in float32.
4. Prints the kernels' JSON line, then the card's line, then as the last
   line {"ok": true, "device": {...}}.  With ``--json-dir DIR`` it also
   writes the per-shape kernel table and a summary there as JSON.

Any failure raises: there is no CPU path and no fallback to a plain version.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}  # bf16: output rounding dominates
REPS = 25


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------- timing -------


class ColdTimer:
    """Median device time of ``fn`` over REPS launches, each after a write
    of 256 MB that evicts the 50 MB L2 (on the main path every layer's K/V
    arrive cold: a layer's weights stream through L2 in between)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPS):
            self.flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def attention_bound(q, k, v, mask):
    """Least time (ms) the card could take for masked attention on these
    inputs, and what bounds it.  Bytes: q and out once, the mask once, and
    the K/V rows some query of the batch row admits (all of V where a row
    is fully masked, since its output is the mean of V).  Operations: 2*D
    per admitted (query head, key) for QK and as many for PV."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    S = k.shape[1]
    elt = q.element_size()
    mb = mask.expand(B, T, S)
    admitted = mb.sum(dim=-1)  # (B, T)
    full_rows = admitted == 0
    keys_k = mb.any(dim=1).sum(dim=-1)  # (B,)
    keys_v = (keys_k + (S - keys_k) * full_rows.any(dim=1)).double()
    nbytes = 2 * q.numel() * elt + mask.numel() + float(((keys_k.double() + keys_v) * Hkv * D * elt).sum())
    pv_keys = admitted + S * full_rows
    ops = float((2 * D * H * (admitted + pv_keys)).double().sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(q.dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- phases ------


def phase_environment(torch):
    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}  nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("set torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(["tree_attention"])
    log(f"built {sorted(logs) or 'nothing (libraries present)'} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def _case_inputs(torch, name, dtype, gen):
    """(q, k, v, mask) at one of the main path's shapes, with masks made by
    the port's own cache functions and unwritten ring lanes left at zero."""
    import numpy as np

    from repro_torch.core.trees import tree_ancestor_mask
    from repro_torch.models.cache import attn_mask_from_pos, cache_slots, tree_mask_from_pos

    S = 1024
    dev = "cuda"

    def ring(B, Hkv, filled):
        k = torch.zeros(B, S, Hkv, 128, device=dev)
        v = torch.zeros(B, S, Hkv, 128, device=dev)
        k[:, :filled] = torch.randn(B, filled, Hkv, 128, generator=gen, device=dev)
        v[:, :filled] = torch.randn(B, filled, Hkv, 128, generator=gen, device=dev)
        return k, v

    def pos_after(length, T):
        pos = torch.full((S,), -1, dtype=torch.int32, device=dev)
        pos[:length + T] = torch.arange(length + T, dtype=torch.int32, device=dev)
        slots = cache_slots(torch.tensor(length, dtype=torch.int32, device=dev), T, S)
        return pos, slots, length + torch.arange(T, dtype=torch.int32, device=dev)

    if name == "target prefill":  # 7 prompt tokens into an empty ring
        B, T, H, Hkv = 1, 7, 32, 8
        pos, _, qpos = pos_after(0, T)
        mask = attn_mask_from_pos(pos, qpos)[:, 0]
        k, v = ring(B, Hkv, T)
    elif name == "target tree pass":  # (2, 2, 2) tree after 40 committed tokens
        B, T, H, Hkv = 1, 7, 32, 8
        parent = [-1, 0, 1, 2, 2, 3, 4]
        anc = torch.as_tensor(tree_ancestor_mask(np.asarray(parent)), device=dev)
        depth = anc.sum(dim=-1).to(torch.int32) - 1
        pos, slots, _ = pos_after(40, T)
        pos[slots.long()] = 40 + depth
        mask = tree_mask_from_pos(pos, 40 + depth, anc[None], slots)[:, 0]
        k, v = ring(B, Hkv, 40 + T)
    elif name == "draft decode":  # one token after 42
        B, T, H, Hkv = 1, 1, 16, 4
        pos, _, qpos = pos_after(42, T)
        mask = attn_mask_from_pos(pos, qpos)[:, 0]
        k, v = ring(B, Hkv, 43)
    elif name == "draft branch step":  # K = 2 forked rows share the (1, T, S) mask
        B, T, H, Hkv = 2, 1, 16, 4
        pos, _, qpos = pos_after(44, T)
        mask = attn_mask_from_pos(pos, qpos)[:, 0]
        k, v = ring(B, Hkv, 45)
    else:  # random per-row mask with a fully masked row
        B, T, H, Hkv = 2, 7, 32, 8
        mask = torch.rand(B, T, S, generator=gen, device=dev) < 0.5
        mask[1, 3] = False
        k = torch.randn(B, S, Hkv, 128, generator=gen, device=dev)
        v = torch.randn(B, S, Hkv, 128, generator=gen, device=dev)
    q = torch.randn(B, T, H, 128, generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask.contiguous()


CASES = ["target prefill", "target tree pass", "draft decode", "draft branch step",
         "random mask, fully masked row"]


def phase_kernels(torch):
    log("== phase 2: tree_attention against its plain version on the card")
    import torch.nn.functional as F

    from repro_torch.kernels.ref import tree_attention_ref
    from repro_torch.kernels.tree_attention import tree_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = ColdTimer(torch)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for case in CASES:
            q, k, v, mask = _case_inputs(torch, case, dtype, gen)
            out = tree_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = tree_attention_ref(q, k, v, mask)
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all() or err > TOLERANCE[dname]:
                raise RuntimeError(f"tree_attention disagrees with its plain version: {case} {dname} "
                                   f"max abs err {err} > {TOLERANCE[dname]} (or not finite)")
            qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
            m4 = mask[:, None]

            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=m4, enable_gqa=True)

            ms = timer(lambda: tree_attention(q, k, v, mask))
            plain_ms = timer(lambda: tree_attention_ref(q, k, v, mask))
            library_ms = timer(sdpa)
            bound_ms, bound_by = attention_bound(q, k, v, mask)
            row = {"case": case, "dtype": dname, "shape": {"B": q.shape[0], "T": q.shape[1], "H": q.shape[2],
                   "Hkv": k.shape[2], "S": k.shape[1], "D": q.shape[3], "Bm": mask.shape[0]},
                   "max_abs_err": err, "tolerance": TOLERANCE[dname], "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            rows.append(row)
            log(f"  {case:30s} {dname:8s} err {err:.3e} (tol {TOLERANCE[dname]:.0e})  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})")
    return rows


def _run_engine(torch, eng, prompts, max_new, n_layers):
    """Serve the prompts with the launch count set to 0 just before and
    read just after; check it equals masked passes x layers."""
    from repro_torch.kernels.tree_attention import tree_attention

    vocab = eng.tc.vocab
    torch.cuda.synchronize()
    tree_attention.launches = 0
    t0 = time.perf_counter()
    outs = [eng.generate(p, max_new=max_new) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tree_attention.launches
    c = eng.counters
    n_tgt, n_drf = n_layers
    expected = n_tgt * (len(prompts) + c["target_calls"]) + n_drf * (len(prompts) + c["draft_calls"])
    if launches == 0 or launches != expected:
        raise RuntimeError(f"tree_attention launched {launches} times, expected {expected} "
                           "(masked attention passes x layers)")
    for out in outs:
        if len(out) != max_new or not all(0 <= t < vocab for t in out):
            raise RuntimeError(f"bad output tokens: {out}")
    be = c["accepted"] / max(c["blocks"], 1) + 1
    K, L1, L2 = eng.ecfg.K, eng.ecfg.L1, eng.ecfg.L2
    if not 1.0 <= be <= 1 + L1 + L2:
        raise RuntimeError(f"block efficiency {be} outside [1, {1 + L1 + L2}]")
    return outs, wall, launches, be


def _profile(torch, eng, prompt):
    """Where the time goes in one request of 16 tokens: device time by
    kernel from torch.profiler (CUPTI), and the device's busy share of the
    profiled wall time (the profiler's own host cost inflates that wall)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompt, max_new=16)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    steps = eng.counters["blocks"]
    attn_ms = sum(t for n, t in by_name.items() if "tree_attention_kernel" in n)
    log(f"  profile: {steps} steps, wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), tree_attention {attn_ms:.2f} ms "
        f"({100 * attn_ms / max(busy_ms, 1e-9):.1f} % of busy)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, t in top:
        log(f"    device {t:9.3f} ms  {name[:100]}")
    ops = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()]
    torch_host_ms = sum(t for _, t, _ in ops)
    log(f"  host: {torch_host_ms:.2f} ms inside torch ops (self CPU time, waits in copies to the host included), "
        f"{wall_ms - torch_host_ms:.2f} ms outside them (Python, numpy verification)")
    host = sorted(ops, key=lambda r: -r[1])[:8]
    for name, t, n in host:
        log(f"    host self {t:9.3f} ms  x{n:<6d} {name[:80]}")
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms, "tree_attention_ms": attn_ms,
            "torch_host_ms": torch_host_ms, "top_kernels_ms": top, "top_host_self_ms": host}


def phase_main_path(torch):
    log("== phase 3: main path, full-width granite-8b + draft, bf16")
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine

    tcfg = get_config("granite-8b")
    dcfg = make_draft_cfg(tcfg)
    log(f"target {tcfg.name}: L={tcfg.n_layers} d={tcfg.d_model} H={tcfg.n_heads} Hkv={tcfg.n_kv_heads} "
        f"hd={tcfg.hd} ff={tcfg.d_ff} V={tcfg.vocab} ({tcfg.param_count() / 1e9:.2f} B params)")
    log(f"draft  {dcfg.name}: L={dcfg.n_layers} d={dcfg.d_model} H={dcfg.n_heads} Hkv={dcfg.n_kv_heads} "
        f"hd={dcfg.hd} ff={dcfg.d_ff} ({dcfg.param_count() / 1e9:.2f} B params)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
    dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    log(f"weights drawn on the card in {time.perf_counter() - t0:.2f} s")
    layers = (tcfg.n_layers, dcfg.n_layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(3)]
    sampling = SamplingParams(1.0, 1.0)

    warm = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=9), sampling)
    warm.generate(prompts[0], max_new=8)  # cuBLAS and allocator warm-up, not measured

    results = {}
    total_launches = 0
    for verifier, reqs in (("specinfer", prompts[:2]), ("traversal", prompts[2:])):
        eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig(verifier, 2, 2, 2, 1024, seed=0), sampling)
        outs, wall, launches, be = _run_engine(torch, eng, reqs, 32, layers)
        total_launches += launches
        tokens = sum(len(o) for o in outs)
        c = eng.counters
        for r, out in enumerate(outs):
            log(f"  {verifier} req{r}: {out}")
        log(f"  {verifier} (2,2,2): block_efficiency={be:.4f} blocks={c['blocks']} "
            f"target_calls={c['target_calls']} draft_calls={c['draft_calls']} tokens={tokens} "
            f"wall={wall:.4f} s tokens/s={tokens / wall:.3f} tree_attention launches={launches} "
            f"(= {layers[0]} x {len(reqs) + c['target_calls']} + {layers[1]} x {len(reqs) + c['draft_calls']})")
        results[verifier] = {"block_efficiency": be, "wall_s": wall, "tokens_per_s": tokens / wall,
                             "launches": launches, "tokens": tokens, "steps": c["blocks"]}
    peak = torch.cuda.max_memory_allocated()
    log(f"  max_memory_allocated {peak / 2**30:.3f} GiB")
    results["max_memory_allocated"] = peak
    eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=1), sampling)
    results["profile"] = _profile(torch, eng, prompts[0])
    del tp, dp, warm, eng
    torch.cuda.empty_cache()
    return results, total_launches


def phase_reference(torch):
    """The full-width draft in float32: the card (kernel) against the CPU
    (plain versions), prefill then a (2, 2, 2) tree pass, same weights."""
    log("== phase 3b: full-width draft on the card against the CPU, float32")
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.trees import tree_ancestor_mask
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.models.transformer import forward, init_cache, init_params

    cfg = make_draft_cfg(get_config("granite-8b")).replace(dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2))

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    cpu_params = to_cpu(params)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, size=(1, 7))
    tree_tokens = rng.integers(0, cfg.vocab, size=(1, 7))
    anc = tree_ancestor_mask(np.asarray([-1, 0, 1, 2, 2, 3, 4]))[None]
    worst = 0.0
    caches = {d: init_cache(cfg, 1, 1024, d) for d in ("cuda", "cpu")}
    for mode, toks in (("full", prompt), ("tree", tree_tokens)):
        logits = {}
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            lg, caches[dev], _ = forward(p, cfg, torch.as_tensor(toks, device=dev), mode=mode,
                                         cache=caches[dev], anc=torch.as_tensor(anc, device=dev)
                                         if mode == "tree" else None)
            logits[dev] = lg.cpu()
        scale = max(1.0, logits["cpu"].abs().max().item())
        rel = (logits["cuda"] - logits["cpu"]).abs().max().item() / scale
        worst = max(worst, rel)
        log(f"  {mode}: max |logits card - logits cpu| / max(1, max |logits|) = {rel:.3e}")
        if not torch.isfinite(logits["cuda"]).all() or rel > 1e-3:
            raise RuntimeError(f"full-width draft on the card disagrees with the CPU in {mode} mode: {rel}")
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json-dir", type=Path, help="also write the result tables there as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; this script runs on the card only")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke.py: {SRC / 'repro_torch'} is missing; run it from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    smi = phase_environment(torch)
    rows = phase_kernels(torch)
    main_path, launches = phase_main_path(torch)
    ref_err = phase_reference(torch)

    # the kernels line reports the target tree pass in bf16: the hottest shape of the path
    headline = next(r for r in rows if r["case"] == "target tree pass" and r["dtype"] == "bfloat16")
    kernels = {"kernels": [{
        "name": "tree_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_attention.cu",
        "replaces": "src/repro/kernels/tree_attention.py:189",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "at": "target tree pass, bf16, B=1 T=7 H=32 Hkv=8 S=1024 D=128",
    }]}
    summary = {"main_path": main_path, "draft_card_vs_cpu_rel_err": ref_err, "nvidia_smi": smi,
               "seconds": time.perf_counter() - t_start}
    if args.json_dir:
        args.json_dir.mkdir(parents=True, exist_ok=True)
        (args.json_dir / "chip_smoke_kernels.json").write_text(json.dumps(rows, indent=1))
        (args.json_dir / "chip_smoke_summary.json").write_text(json.dumps({**summary, **kernels}, indent=1))
    log(f"== done in {summary['seconds']:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
