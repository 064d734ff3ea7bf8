"""Speculative-decoding serving launcher (single stream).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --verifier specinfer --K 2 --L1 2 --L2 2 --requests 2 --max-new 32

The counterpart of src/repro/launch/serve.py without ``--streams``: builds
a target and a proportionally smaller draft of the same family with random
weights drawn from ``--seed``, serves synthetic requests through the
speculative engine and reports block efficiency and throughput.  It runs on
``--device cuda`` (the default) and raises when no CUDA device is present;
``--device cpu`` runs every kernel's plain version instead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.verify import verifier_names
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine


def make_draft_cfg(cfg):
    """A ~10x smaller draft of the same family (paper: ~9:1 .. 100:1).

    The dense rule of src/repro/launch/serve.py ``make_draft_cfg``; the
    other families' rules come with the slices that port those families."""
    kw = dict(
        name=cfg.name + "-draft",
        n_layers=max(cfg.n_layers // 4, 1),
        d_model=max(cfg.d_model // 2, 64),
        d_ff=max(cfg.d_ff // 2, 64),
        n_heads=max(cfg.n_heads // 2, 1),
        n_kv_heads=max(cfg.n_kv_heads // 2, 1),
    )
    if cfg.head_dim:
        kw["head_dim"] = cfg.head_dim
    return cfg.replace(**kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--verifier", default="specinfer", choices=verifier_names(),
                    help="verification algorithm (core/verify.py registry; "
                         "single-path verifiers bv/naive_single need --K 1)")
    ap.add_argument("--K", type=int, default=2)
    ap.add_argument("--L1", type=int, default=2)
    ap.add_argument("--L2", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device the models run on (cuda, or cpu for the plain versions)")
    ap.add_argument("--streams", type=int, default=0,
                    help="continuous batching: not ported yet (ROADMAP queue 1 item 6)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.streams:
        raise NotImplementedError("--streams (continuous batching) is not ported: ROADMAP queue 1 item 6")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is false; "
                           "pass --device cpu to run the plain versions on the CPU")

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dcfg = make_draft_cfg(cfg)
    tp = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    dp = init_params(dcfg, torch.Generator(device=device).manual_seed(args.seed + 1))

    ecfg = EngineConfig(verifier=args.verifier, K=args.K, L1=args.L1, L2=args.L2,
                        max_cache=1024, seed=args.seed)
    eng = SpeculativeEngine(cfg, tp, dcfg, dp, ecfg, SamplingParams(args.temperature, args.top_p))
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for r in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=8).tolist()
        out = eng.generate(prompt, max_new=args.max_new)
        print(f"req{r}: {out[:16]}{'...' if len(out) > 16 else ''}")
    dt = time.perf_counter() - t0
    c = eng.counters
    be = c["accepted"] / max(c["blocks"], 1) + 1
    print(
        f"\nverifier={args.verifier} ({args.K},{args.L1},{args.L2}) "
        f"block_efficiency={be:.3f} target_calls={c['target_calls']} "
        f"draft_tokens={c['draft_tokens']} wall={dt:.1f}s "
        f"tokens/s({device.type})={args.requests * args.max_new / dt:.2f}"
    )


if __name__ == "__main__":
    main()
