"""Speculative-decoding serving launcher.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --verifier specinfer --K 2 --L1 2 --L2 2 --requests 2 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --streams 8 --requests 12 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch qwen3-moe-235b-a22b --streams 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch recurrentgemma-2b --streams 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch granite-8b --streams 4 --requests 6 --data-shards 2
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.serve \
        --distributed --device cpu --smoke --arch granite-8b --streams 4 \
        --requests 6 --data-shards 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch granite-8b --verifier spectr --verify-on-device
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch internvl2-26b

The counterpart of src/repro/launch/serve.py: builds a target and a
proportionally smaller draft of the same family with random weights drawn
from ``--seed``, serves synthetic requests through the single-stream
speculative engine, or with ``--streams N`` through the continuous-batching
engine over an N-row pool (paged, ragged auto-dispatch and pipelined
stepping by default, as in the JAX launcher), with ``--data-shards N``
through the sharded engine (N slot shards, each its own arena), and reports
block efficiency and throughput; the batched engines' report adds the
host's time by phase (serving/spans.py), in ms a verified step.  ``--distributed`` serves the sharded
engine with one shard a rank under ``torchrun --nproc_per_node N``: a
``gloo`` process group, each rank's device ``cuda:(LOCAL_RANK % cards)``
(or the CPU under ``--device cpu``), the same weights drawn from
``--seed`` and the same prompts on every rank; rank 0 prints the report of
the single-process ``--data-shards N``.  ``--verify-on-device`` verifies the
single-stream engine's top-down OT verifiers on the device (the JAX
launcher has no such flag; its engines take ``verify_on_device`` in
``EngineConfig``).  The SSM and hybrid targets (mamba2-2.7b,
recurrentgemma-2b) take the replay target-pass strategy; a pure SSM pool
has no KV to page.  whisper-medium serves single-stream only (the batched
engines refuse encdec and vlm targets, as in JAX) on frame embeddings
drawn from the launcher's rng before the prompts, as the JAX launcher
draws them; internvl2-26b serves text-only, as there.  It runs on
``--device cuda`` (the default) and raises when no CUDA device is present;
``--device cpu`` runs every kernel's plain version instead.
"""
from __future__ import annotations

import argparse
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.verify import verifier_names
from repro_torch.launch.mesh import rank_shard
from repro_torch.models.transformer import init_params
from repro_torch.serving.batch_engine import BatchedSpeculativeEngine, ShardedBatchedSpeculativeEngine
from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine
from repro_torch.serving.spans import per_step_ms, prefill_pad_pct, readback_used_pct


def make_draft_cfg(cfg):
    """A ~10x smaller draft of the same family (paper: ~9:1 .. 100:1).

    The rules of src/repro/launch/serve.py ``make_draft_cfg``: an SSM draft
    keeps a quarter of the layers at half the width; a hybrid draft keeps
    half the (rec, rec, attn) groups (at least one) at half the width, lru
    width and d_ff, with the target's heads; an MoE draft keeps half the
    experts and top_k capped at that; an encoder-decoder draft keeps a
    quarter of the encoder layers too."""
    if cfg.arch_type == "ssm":
        return cfg.replace(name=cfg.name + "-draft", n_layers=max(cfg.n_layers // 4, 1),
                           d_model=max(cfg.d_model // 2, 64))
    if cfg.arch_type == "hybrid":
        nl = max((cfg.n_layers // cfg.hybrid_attn_every) // 2 * cfg.hybrid_attn_every, cfg.hybrid_attn_every)
        return cfg.replace(name=cfg.name + "-draft", n_layers=nl, d_model=max(cfg.d_model // 2, 64),
                           lru_width=max(cfg.lru_d // 2, 64), d_ff=max(cfg.d_ff // 2, 64))
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
    if cfg.arch_type == "moe":
        kw["n_experts"] = max(cfg.n_experts // 2, 2)
        kw["top_k"] = min(cfg.top_k, max(cfg.n_experts // 2, 2))
    if cfg.arch_type == "encdec":
        kw["n_enc_layers"] = max(cfg.n_enc_layers // 4, 1)
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
    ap.add_argument("--verify-on-device", action="store_true",
                    help="single stream: verify the top-down OT verifiers on the device "
                         "(core/otlp_device.py); the batched engines refuse it, as in JAX")
    ap.add_argument("--streams", type=int, default=0,
                    help="continuous batching: serve through an N-slot cache pool "
                         "(0 = sequential single-stream engine)")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="with --streams: split the pool into N slot shards, each with its own "
                         "arena and free list, routed by one scheduler (N > 1)")
    ap.add_argument("--block-size", type=int, default=64,
                    help="paged KV pool block size in tokens (rounded down to "
                         "the nearest power of two dividing max_cache)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="total arena blocks shared by all streams (0 = "
                         "ring-equivalent capacity, streams * max_cache/block)")
    ap.add_argument("--ring", action="store_true",
                    help="disable the paged KV pool and reserve a full "
                         "max_cache ring per stream")
    ap.add_argument("--pipeline", default=True, action=argparse.BooleanOptionalAction,
                    help="pipelined stepping (token-identical; --no-pipeline "
                         "restores strictly sequential steps)")
    ap.add_argument("--ragged", default=True, action=argparse.BooleanOptionalAction,
                    help="ragged node-major tree batching whenever it ships fewer "
                         "lanes than the padded block (token-identical; --no-ragged "
                         "pins the padded layout)")
    ap.add_argument("--distributed", action="store_true",
                    help="with --streams and --data-shards N, under torchrun --nproc_per_node N: one shard a "
                         "rank of a gloo process group, each on cuda:(LOCAL_RANK %% cards) or the cpu")
    return ap


def build_models(args, device):
    """(target config, target weights, draft config, draft weights) drawn on
    ``device`` from ``--seed`` (the draft from ``--seed`` + 1)."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dcfg = make_draft_cfg(cfg)
    tp = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    dp = init_params(dcfg, torch.Generator(device=device).manual_seed(args.seed + 1))
    return cfg, tp, dcfg, dp


def engine_config(args):
    return (EngineConfig(verifier=args.verifier, K=args.K, L1=args.L1, L2=args.L2, max_cache=1024,
                         seed=args.seed, verify_on_device=args.verify_on_device),
            SamplingParams(args.temperature, args.top_p))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.distributed:
        serve_distributed(args)
        return
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is false; "
                           "pass --device cpu to run the plain versions on the CPU")

    cfg, tp, dcfg, dp = build_models(args, device)
    ecfg, sampling = engine_config(args)
    rng = np.random.default_rng(args.seed)
    if args.streams:
        serve_batched(args, cfg, tp, dcfg, dp, ecfg, sampling, rng, device)
        return
    eng = SpeculativeEngine(cfg, tp, dcfg, dp, ecfg, sampling)
    t0 = time.perf_counter()
    kw = {}
    if cfg.arch_type == "encdec":
        kw["enc_embeds"] = torch.as_tensor(rng.standard_normal((1, cfg.enc_len, cfg.d_model)), dtype=cfg.tdtype,
                                           device=device)
    for r in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=8).tolist()
        out = eng.generate(prompt, max_new=args.max_new, **kw)
        print(f"req{r}: {out[:16]}{'...' if len(out) > 16 else ''}")
    dt = time.perf_counter() - t0
    c = eng.counters
    be = c["accepted"] / max(c["blocks"], 1) + 1
    print(
        f"\nverifier={args.verifier}{' on the device' if args.verify_on_device else ''} "
        f"({args.K},{args.L1},{args.L2}) "
        f"block_efficiency={be:.3f} target_calls={c['target_calls']} "
        f"draft_tokens={c['draft_tokens']} wall={dt:.1f}s "
        f"tokens/s({device.type})={args.requests * args.max_new / dt:.2f}"
    )


def serve_distributed(args, requests=None) -> dict:
    """``--distributed``: this process serves its shard as a rank of the
    default process group (started here over ``gloo`` from ``torchrun``'s
    environment, and ended here, unless one exists).  ``requests`` as in
    ``serve_batched``."""
    if not args.streams:
        raise ValueError("--distributed serves the sharded pool: pass --streams N --data-shards S")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--distributed --device cuda but torch.cuda.is_available() is false; "
                           "pass --device cpu to serve the ranks on the CPU")
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", timeout=timedelta(minutes=10))
    try:
        rank, device = rank_shard(torch.device(args.device).type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        cfg, tp, dcfg, dp = build_models(args, device)
        ecfg, sampling = engine_config(args)
        return serve_batched(args, cfg, tp, dcfg, dp, ecfg, sampling, np.random.default_rng(args.seed), device,
                             group=dist.group.WORLD, requests=requests, report=rank == 0)
    finally:
        if own:
            dist.destroy_process_group()


def serve_batched(args, cfg, tp, dcfg, dp, ecfg, sampling, rng, device, group=None, requests=None,
                  report=True) -> dict:
    """Serve ``requests`` ([(prompt, max_new, seed)], by default
    ``--requests`` 8-token prompts drawn from ``rng``, ``--max-new`` each,
    seeds from ``--seed``) through the batched engine, or the sharded one
    (``--data-shards`` > 1, or a process group: one shard a rank).  Prints
    the report when ``report``; returns the engine, each request's
    ``{"tokens", "reason"}`` and shard, and the wall time."""
    kw = dict(n_slots=args.streams, paged=not args.ring, block_size=args.block_size,
              pool_blocks=args.pool_blocks or None, pipeline=args.pipeline, ragged=args.ragged)
    sharded = args.data_shards > 1 or group is not None
    if sharded:
        eng = ShardedBatchedSpeculativeEngine(cfg, tp, dcfg, dp, ecfg, sampling, data_shards=args.data_shards,
                                              group=group, **kw)
    else:
        eng = BatchedSpeculativeEngine(cfg, tp, dcfg, dp, ecfg, sampling, **kw)
    if requests is None:
        requests = [(rng.integers(0, cfg.vocab, size=8).tolist(), args.max_new, args.seed + r)
                    for r in range(args.requests)]
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in requests]
    routing = [eng.shard_of(r) for r in rids] if sharded else None
    outs = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    res = {"engine": eng, "outs": [outs[r] for r in rids], "routing": routing, "wall_s": dt}
    if not report:
        return res
    for r, rid in enumerate(rids):
        out = outs[rid]["tokens"]
        print(f"req{r}: {out[:16]}{'...' if len(out) > 16 else ''}")
    c = eng.counters
    be = c["accepted"] / max(c["blocks"], 1) + 1
    pool = "ring" if not eng.paged else (
        f"paged(block={eng.block_size}, arena={eng.pool_blocks} blocks, "
        f"peak={c['blocks_peak']} used, reclaimed={c['blocks_reclaimed']})")
    stepping = (f"pipelined(ahead={c['pipeline_ahead']}, stalls={c['pipeline_stalls']}"
                f"/{c['pipeline_iterations']} iters)" if args.pipeline else "sync")
    if sharded:
        per = [sh.counters["blocks_peak"] for sh in eng.shards]
        stepping += (f" shards={args.data_shards}(x{eng.n_slots // args.data_shards} slots, peaks={per}, "
                     f"commits={c['commit_calls']} of which {eng.grouped_commits} grouped)")
        if group is not None:
            stepping += f" ranks={args.data_shards}(a shard each, exchanges={sum(eng.exchanges.values())})"
    print(
        f"\n[batched x{args.streams}] verifier={args.verifier} ({args.K},{args.L1},{args.L2}) "
        f"block_efficiency={be:.3f} target_calls={c['target_calls']} "
        f"(ragged {c['ragged_calls']}, padded {c['padded_calls']}) draft_tokens={c['draft_tokens']} "
        f"evicted={c['evicted']} pool={pool} stepping={stepping} wall={dt:.1f}s "
        f"tokens/s({device.type})={sum(len(o['tokens']) for o in outs.values()) / dt:.2f}"
    )
    print(phase_report(eng.span_totals))
    return res


def phase_report(totals: dict) -> str:
    """One line of the host's time by phase, in ms a verified step (a
    shard's, in the sharded forms), with the prefill's padding and the
    share of the read-back bytes that were read."""
    steps = totals.get("verify", {}).get("calls", 0)
    ms = " ".join(f"{name}={v:.2f}" for name, v in per_step_ms(totals, steps).items())
    pad, used = prefill_pad_pct(totals) or 0.0, readback_used_pct(totals) or 0.0
    return (f"host ms/step ({steps} verified steps): {ms} | prefill pad={pad:.1f}% "
            f"readback used={used:.1f}% of {totals.get('readback', {}).get('bytes', 0) / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
