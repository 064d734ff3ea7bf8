#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json-dir DIR]   # from the root of a checkout, on a machine with a card

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off for float32 matmuls; builds every kernel of the
   paths from src/repro_torch/kernels/csrc with nvcc (one process per
   source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, in float32 and bfloat16, with the tolerance stated; times
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (``library_ms``; a yardstick only: the port
   never calls it), else the composition of PyTorch calls that does
   (``composed_ms``, e.g. the block-table gather then SDPA), with CUDA
   events, a cold L2 before every launch, median of several launches; and
   the least time the card could take for the same work (bound_ms).  For
   commit_kv and the flash-decode wrappers it also gives the host time of
   a call (``host_ms``) and the reading without ColdTimer's spin kernel
   (``unspun_ms``).  The
   tree kernels run at the granite pair's heads and at the MoE pair's (H 64,
   Hkv 4 and H 32, Hkv 2), and commit_kv on the arenas of both pairs and at
   3072 entries over 36 layers.  The
   tree kernels' long-cache rows (a 32768-slot ring, rows of 512 64-slot
   blocks, after ~30000 committed tokens) run their split path.  Every
   tree-kernel row is also held per query row to TOLERANCE times the row's
   own largest |output| (TREE_TOLERANCE_RULE), and on each long row the
   plain version with the first split's keys left out must fail that
   check (the control).  The flash-decode kernels, which no engine calls
   (nor does one in the JAX package), run dense at decode_32k's seq (B 16,
   S 32768; granite-8b's, Llama-3 70B's and qwen3-moe's heads, G 4, 8 and
   16; window 0 and 8192; lengths >= 1, with SDPA beside them, or with a
   row at length 0), alone at B 128 against SDPA, and paged on phase 4's
   arena and on rows of 512 blocks; their outputs are averages over up to
   32768 slots (~0.02-0.06), so each batch row is held to TOLERANCE times
   its own largest |output| (DECODE_TOLERANCE_RULE); and at the other
   head_dims the repo's models use (DECODE_WIDTHS: 32 and 48 at
   examples/serve_speculative.py's heads, 256 at recurrentgemma-2b's under
   its 2048-slot window, each with a window and without, dense and paged
   on a 4096-slot cache).  The tree kernels'
   head_dim-256 instances run at recurrentgemma-2b's heads (H 10, Hkv 1)
   under its 2048-slot window: the single-stream trunk and commit passes
   (on a 1024-slot ring and past the window on a 4096-slot one), phase
   7c's 2600-token prefill (434 query tiles in one batch row), the
   batched branch replay's 16 forked rows, and 8 paged rows (the 8-token
   admission prefill, short rows and rows past the window); the draft's
   D 128 instance at the same heads (G 10) in its forked branch step and
   its 2600-token prefill; SDPA or gather+SDPA beside each.  Phase 9's
   shapes too (FAMILY_CASES): whisper-medium's tree pass (16/16 heads of
   64, G 1), internvl2-26b's (48/8 heads of 128, G 6: 126 score rows a
   tile, the last m16 tile part filled) and its 263-row prefill of 256
   patches + 7 tokens (13 query tiles).  And examples/serve_speculative.py's
   heads (EXAMPLE_HEADS: the target's 6/2 of 32, the draft's 2/1 of 48,
   which phase 10d serves) through kernels 1-3: prefill, tree pass, draft
   decode and branch step, padded, trunk and ragged passes, and the long
   rows' split path at each head_dim.
3. The main path at full width: granite-8b (36 layers, bf16) with its
   make_draft_cfg draft, random weights drawn on the card from seeded
   generators, served by SpeculativeEngine with specinfer at
   (K, L1, L2) = (2, 2, 2) for 2 requests x 32 new tokens, then 1 request
   with traversal.  Kernel launch counts are set to 0 just before each run
   and must equal the masked attention passes x layers just after.  The
   output is checked: tokens in the vocabulary, block efficiency within its
   range, and the full-width draft's logits on the card (kernel) against the
   same forward on the CPU (plain versions) in float32.
4. The batched path at full width: the same models served by
   BatchedSpeculativeEngine (8 rows, paged arena of 64-slot blocks, ragged
   auto-dispatch) with specinfer at (2, 2, 2) for 12 requests of 8-token
   prompts and 16-48 new tokens, pipelined, then synchronous with the same
   seeds, then 3 of the requests through SpeculativeEngine.  Each kernel's
   launch count is set to 0 just before each batched run and must equal its
   passes x layers just after; both the padded and the ragged tree pass must
   have run; pipelined tokens must equal synchronous tokens.  Reports
   throughput, block efficiency, pad fraction, peak blocks and memory, how
   many streams match the single-stream engine, a profile of a few steps,
   and a float32 check of one paged, one ragged and one commit pass of the
   full-width draft on the card against the CPU.
5. The MoE path at full width: qwen3-moe-235b-a22b with n_layers cut from
   94 to 8 (the whole model is 437.9 GiB in bf16) and make_draft_cfg of the
   full config (23 layers, 64 experts top-8), random weights drawn on the
   card after the granite models are freed: one specinfer (2, 2, 2) request
   of 32 tokens through SpeculativeEngine, then the batched run of phase 4
   (pipelined, then synchronous), launch counts exact, pipelined tokens
   equal to synchronous ones, peak memory, a profile; then the MoE draft cut
   to 2 layers in float32 on the card against the CPU (phase 4b's passes).
6. Dynamic delayed expansion, the paper's flow, on phases 3-4's models
   (full-width granite-8b and its draft, the same seeds, bf16): (a) fit
   LatencyModel to the engine's own timed passes (a one-token draft decode
   after 16-896 committed tokens, target tree passes of 2, 7 and 15 nodes);
   (b) label the roots of 2 prompts with Eq. 3 (collect_traces, specinfer,
   the action grid of examples/train_selector.py, s = 1); (c) train the
   selector on the card (train_selector, Eq. 12); (d) one stream, 32
   tokens, the best static action against NeuralSelector; (e) phase 4's
   traffic through BatchedSpeculativeEngine under NeuralSelector, then
   under a content-keyed selector whose steps mix actions; (f)
   AnalyticSelector on one request of 8 tokens, and a pooled peek against
   the single-stream peek at the same prefix (pools unchanged bit for bit).
   Launch counts are checked in every run as in phases 3-5.
7. The recurrent families on the replay strategy, at full width, after the
   earlier models are freed: (a) mamba2-2.7b (d 2560, 80 SSD heads of 64,
   state 128; its 64 layers cut to 32 in PR 22 and to 16 in PR 24, the
   draft the full config's) and (b) recurrentgemma-2b (its 26 layers, 8
   groups of (rec, rec, local-attn) and a tail of 2 rec layers, cut to 4
   groups and the tail in PR 24; 10/1 heads of 256, window 2048; the draft
   the full config's), each with its make_draft_cfg draft: one specinfer
   (2, 2, 2) request of 32 tokens through SpeculativeEngine, then phase
   4's traffic through BatchedSpeculativeEngine, pipelined (the
   synchronous runs were cut in PR 24 to make room for phase 8g: the
   replay strategy's pipelined == synchronous tokens are held on the CPU
   by tests/test_torch_replay.py), a profile of one step traced on the
   device only (run first: it also warms the pair's shapes), peak memory; launch counts
   exact (none for mamba2, which has no attention; for the hybrid, its 4
   target and 4 draft attention layers times the passes).  (c) One
   hybrid request of a 2600-token prompt on a 4096-slot ring, past the
   2048-slot window, so the tree kernel skips the dead chunks below it.
   (d) Each full-width draft in float32 on the card against the CPU: a
   prefill, a decode, a 3-token trunk decode from the state and a K = 2
   forked branch pass.  Phase 2 holds the tree kernels' head_dim-256
   instances at the hybrid's heads under its window mask.
8. The sharded engine and verification on the card: (a) phase 4's models
   and traffic through ShardedBatchedSpeculativeEngine (8 rows in 2 shards
   of 4, each its own arena), pipelined then synchronous: launch counts
   exact (summed over the shards; commit_kv once a shard in each grouped
   commit), pipelined == sync tokens, the grouped commit fired, commit
   calls at most phase 4's + 2; streams equal to phase 4's reported; (b)
   phase 7b's recurrentgemma-2b pair and traffic through it, pipelined,
   replay strategy (per-shard commits), launch counts exact; (c) phase 3's
   pair through SpeculativeEngine(verify_on_device=True), one specinfer
   and one spectr request of 32 tokens, launch counts exact, every
   verification on the card, a profile of one step (the verifier's
   kernels, device and host time); (d) each device solver's law (V = 6,
   20000 draws, a CUDA generator) against the numpy oracle, and the tree
   walk's block law at 5000 draws; (e) granite-8b at full width cut to 4
   target layers and a 1-layer draft in float32: how many of 3 streams the
   batched engine serves as the single-stream one does, and of 12 the
   sharded as the unsharded (reported); (f) 8a's configuration and traffic
   (nothing cut) through launch/serve.py's --distributed path, one shard a
   rank: 2 spawned gloo rank processes, each drawing granite-8b + draft
   from the launcher's seed (phase 4's weights) on cuda:(rank % cards),
   so on a one-card machine both ranks share the card; run after phase 4
   has freed its models.  Every request's tokens and reason, the routing
   and each kernel's launches summed over the ranks equal 8a's pipelined
   run; one exchange a step and no other collective; a rank that fails or
   hangs fails the phase; each rank's peak and wall and the aggregate
   tok/s reported beside 8a's; (g) one pool over a data mesh: 2 spawned
   gloo rank processes sharing the card, each building
   BatchedSpeculativeEngine(..., mesh=make_data_mesh(2)) and holding rows
   [4 r, 4 r + 4) of the 8: (a) phase 4's models (drawn on each rank from
   phase 4's seeds) and traffic, bf16, paged, ragged auto, pipelined: both
   ranks return the same tokens and reasons; each rank's exchanges equal
   the design's count (one a draft pass, one a target pass, one a boundary
   that admits, no other collective); each kernel's launches on each rank
   equal the single-process engine's count for the same passes, less the
   passes the rank holds no row of (other ranks' admission prefills, its
   idle ragged passes); matches against phase 4, each rank's peak and
   wall and the aggregate tok/s reported; (b) 8e's float32 cut through
   the same: tokens equal 8e's single-process engine's, 12 of 12.
9. The encoder-decoder and VLM families, each at full width with its
   make_draft_cfg draft, bf16, one stream, after every
   earlier model is freed: (a) whisper-medium (24 + 24 layers, d 1024,
   16/16 heads of 64, enc_len 1500, vocab 51865; draft 6 + 6 layers at d
   512), each request given seeded frame embeddings (1, 1500, 1024); (b)
   internvl2-26b (d 6144, 48/8 heads of 128, d_ff 16384, vocab 92553; its
   48 layers cut to 24 since PR 22; draft 12 layers at d 3072, 24/4 heads,
   the full config's), each request given 256
   seeded patch embeddings (1, 256, 6144).  Each: phase 3's traffic
   (specinfer on 2 requests, traversal on 1, 8-token prompts, 32 new
   tokens, a 1024-slot ring), launch counts exact (the draft never sees
   the frames or patches, as in JAX), the prefill's wall, peak memory
   (under 80 GB), a profile of one request with the device time of what
   runs outside any kernel (the plain encoder layers and cross-attention
   cores, as in JAX).  (c) The whisper draft at full width given frames of
   its own width (1, 1500, 512), and the internvl2 draft cut to 2 layers
   given its patches, float32, the card against the CPU (the logits and
   the cached cross K/V within 1e-3 of their scale; launches exact).
10. Training, after every earlier model is freed; it launches no
   hand-written kernel (they have no backward: training takes the plain
   attention, as the JAX package trains through XLA), and every launch
   count must read 0 across it.  (a) granite-3-2b at full width, nothing
   cut, bf16, remat on: 20 steps of 4 x 1024 SyntheticLM tokens through
   training/loop.train (AdamW lr 3e-4, warmup 1, cosine); the losses
   finite and falling (the last 5's mean under the first), the parameters
   changed, peak memory under 80 GB; the median step, tokens/s, the
   model-FLOP share 6 N tokens / step / PEAK_FLOPS, the device-busy share
   of a 2-step profile; a checkpoint of the full parameters saved, loaded
   and compared bit for bit.  (b) qwen3-moe-235b-a22b at full width cut
   from 94 layers to 1 (two layers' weights, gradients and AdamW state fit
   no card), the MoE capacity-factor dispatch: 5 steps of 2 x 512 tokens,
   losses finite, peak under 80 GB, the share of (token, choice) pairs
   dropped each step (read by an untimed forward pass before the step).
   (c) A train step of every smoke config in float32, the card against
   the CPU: the loss within 1e-4 relative, each gradient leaf within 1e-3
   of its own largest |value| (the recurrent scans' and the capacity
   dispatch's backward on CUDA).  (d) examples/serve_speculative.py's own
   4-layer target (d 192, 6/2 heads of 32) and 1-layer draft (d 96, 2/1
   heads of 48), V 256, float32, trained 120 steps each, then 4 requests
   of 48 tokens through SpeculativeEngine (specinfer, (2, 2, 2)) on the
   tree kernel's head_dim-32 and -48 instances, launch counts exact,
   block efficiency reported.
11. The dry run (launch/dryrun.py): every config x every shape of
   launch/shapes.py on fake tensors in 8 worker processes, one line an
   entry (the step run, its FLOPs counted and its peak of live bytes
   tracked); launch/dryrun.py's H100_BYTES against the card's
   total_memory; a real granite-8b build (bf16, a cache of 8 rows x 4096
   slots) against the dry run's resident_bytes of the same shape, within
   0.1 % + 1 MiB; and the dry run's peak_bytes beside
   max_memory_allocated of one real decode step there (kernel 1 at every
   layer, launches exact) and of one granite-3-2b train step of 1 x 1024
   tokens (no kernel), reported as ratios.  recurrentgemma-2b's prefill_32k
   and train_4k entries run cut to 12 of its 26 layers (DRY_CUT_LAYERS:
   at full depth they alone bound the table, at ~116 s on the H100's host),
   and since PR 24 mamba2-2.7b's to 16 of its 64.
   Phase 11's worker processes also run phase 12c's dry runs.
12. The production meshes (launch/mesh.py, launch/sharding.py,
   models/act_sharding.py, launch/train.py's make_sharded_train_step):
   (a) an NCCL process group of one rank made in-process (HashStore) and a
   1 x 1 ("data", "model") mesh on the card (DTensor replicates
   everything there: it checks the DTensor path on the card, not a split):
   granite-3-2b at full width trained 5 steps of 4 x 1024 tokens in bf16
   from phase 10a's seed and batches, each loss within 1e-3 relative of
   phase 10a's at the same step, its step time and peak beside phase
   10a's; then granite-8b at full width cut to 4 layers in float32, 3
   steps, every leaf within 1e-5 of its largest |value| of the plain
   step's; no kernel launched.  (b) On a machine with 2 or more cards only:
   one NCCL rank a card on a (1, n) and an (n, 1) mesh, the same float32
   check; else it says why it did not run.  (c) On the host, in phase
   11's worker processes: the dry run of granite-8b train_4k and
   decode_32k and qwen3-moe train_4k on the 16x16 and 2x16x16 meshes of a
   fake process group: per-device bytes (held equal to what the specs
   place), peak, FLOPs and collectives.
13. Prints the kernels' JSON line, then the card's line, then as the last
   line {"ok": true, "device": {...}}.  With ``--json-dir DIR`` it also
   writes the per-shape kernel table and a summary there as JSON.

Any failure raises: there is no CPU path and no fallback to a plain version.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
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
# The flash-decode outputs are means over up to 32768 slots of N(0, 1) values,
# ~0.02-0.06 at most, so an absolute 2e-2 would pass zeros.  One bf16 rounding
# of each side differs by at most one ulp, <= 2**-7 of the row's largest |value|.
DECODE_TOLERANCE_RULE = "max|out - ref| of each batch row <= TOLERANCE x max|ref| of that row"
# The tree kernels' outputs on a long cache are means over ~30000 slots, ~0.01-0.03,
# so each query row is also held to its own scale (a padding lane's zeros exactly).
TREE_TOLERANCE_RULE = ("max|out - ref| <= TOLERANCE and, in each query row, "
                       "max|out - ref| <= TOLERANCE x max|ref| of that row")
REPS = 25
KERNEL_SOURCES = ["tree_attention", "paged_tree_attention", "commit_kv", "decode_attention", "decode_attention_f32"]


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------- timing -------


class ColdTimer:
    """Median device time of ``fn`` over REPS launches, each after a write
    of 256 MB that evicts the 50 MB L2 (on the main path every layer's K/V
    arrive cold: a layer's weights stream through L2 in between).  A spin
    kernel of ~0.5 ms then keeps the card busy while the host enqueues
    ``fn``, so the start event fires with ``fn`` already queued: the time
    holds no host gap.  With ``spin=False`` (no spin kernel) only the
    ~0.08 ms flush covers the host's work, so a call whose host work
    outlasts it adds the excess to the reading.  ``host_ms`` is the median
    host time of the last call's ``fn()`` (the wrapper's checks,
    allocations and launch, the card busy meanwhile)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.host_ms = float("nan")

    def __call__(self, fn, spin=True) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times, hosts = [], []
        for _ in range(REPS):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(1_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            hosts.append(time.perf_counter() - t0)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        self.host_ms = statistics.median(hosts) * 1e3
        return statistics.median(times)

    def wrapper(self, fn) -> dict:
        """A wrapper's readings: ``ms`` (spun), ``host_ms`` and
        ``unspun_ms`` (``spin=False``)."""
        ms = self(fn)
        host_ms = self.host_ms
        return {"ms": ms, "host_ms": host_ms, "unspun_ms": self(fn, spin=False)}


def rows_bound(torch, q_rows, mask_rows, group, n_groups, hkv, extra_bytes):
    """Least time (ms) the card could take for masked attention, and what
    bounds it.  q_rows (R, H, D): every query row; mask_rows (R, S): its
    mask; group (R,): the K/V view (batch row, or owner) each row reads.
    Bytes: q and out once, ``extra_bytes`` (the mask as stored, tables),
    and the K/V rows some query of a view admits (all of V where a row is
    fully masked, since its output is the mean of V).  Operations: 2*D per
    admitted (query head, key) for QK and as many for PV."""
    R, H, D = q_rows.shape
    S = mask_rows.shape[1]
    elt = q_rows.element_size()
    admitted = mask_rows.sum(dim=-1)  # (R,)
    full_rows = admitted == 0
    union = torch.zeros(n_groups, S, dtype=torch.int32, device=mask_rows.device)
    union.index_add_(0, group, mask_rows.to(torch.int32))
    keys_k = (union > 0).sum(dim=-1).double()
    full = torch.zeros(n_groups, dtype=torch.int32, device=mask_rows.device)
    full.index_add_(0, group, full_rows.to(torch.int32))
    keys_v = keys_k + (S - keys_k) * (full > 0)
    nbytes = 2 * q_rows.numel() * elt + extra_bytes + float(((keys_k + keys_v) * hkv * D * elt).sum())
    pv_keys = admitted + S * full_rows
    ops = float((2 * D * H * (admitted + pv_keys)).double().sum())
    return _bound(nbytes, ops, q_rows.dtype)


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(q, k, v, mask):
    """``rows_bound`` of tree attention over a dense K/V view."""
    import torch

    B, T, H, D = q.shape
    S = k.shape[1]
    rows = mask.expand(B, T, S).reshape(B * T, S)
    group = torch.arange(B, device=q.device).repeat_interleave(T)
    return rows_bound(torch, q.reshape(B * T, H, D), rows, group, B, k.shape[2], mask.numel())


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
    logs = build.build(KERNEL_SOURCES)
    log(f"built {sorted(logs) or 'nothing (libraries present)'} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def _case_inputs(torch, name, dtype, gen, heads=None, D=128):
    """(q, k, v, mask) at one of the main path's shapes, with masks made by
    the port's own cache functions and unwritten ring lanes left at zero.
    ``heads`` = (H, Hkv) replaces the granite pair's heads (the MoE pair's,
    or at head_dim ``D`` the example's).  The "long" cases take a
    LONG_S-slot ring (the split path)."""
    import numpy as np

    from repro_torch.core.trees import tree_ancestor_mask
    from repro_torch.models.cache import attn_mask_from_pos, cache_slots, tree_mask_from_pos

    S = LONG_S if name.startswith("long") else 1024
    dev = "cuda"

    def hk(H, Hkv):
        return heads or (H, Hkv)

    def ring(B, Hkv, filled):
        k = torch.zeros(B, S, Hkv, D, device=dev)
        v = torch.zeros(B, S, Hkv, D, device=dev)
        k[:, :filled] = torch.randn(B, filled, Hkv, D, generator=gen, device=dev)
        v[:, :filled] = torch.randn(B, filled, Hkv, D, generator=gen, device=dev)
        return k, v

    def pos_after(length, T):
        pos = torch.full((S,), -1, dtype=torch.int32, device=dev)
        pos[:length + T] = torch.arange(length + T, dtype=torch.int32, device=dev)
        slots = cache_slots(torch.tensor(length, dtype=torch.int32, device=dev), T, S)
        return pos, slots, length + torch.arange(T, dtype=torch.int32, device=dev)

    if name == "target prefill":  # 7 prompt tokens into an empty ring
        (B, T), (H, Hkv) = (1, 7), hk(32, 8)
        pos, _, qpos = pos_after(0, T)
        mask = attn_mask_from_pos(pos, qpos)[:, 0]
        k, v = ring(B, Hkv, T)
    elif name in ("target tree pass", "long target tree pass"):  # (2, 2, 2) tree after C committed tokens
        (B, T), (H, Hkv) = (1, 7), hk(32, 8)
        C = LONG_COMMITTED if name.startswith("long") else 40
        parent = [-1, 0, 1, 2, 2, 3, 4]
        anc = torch.as_tensor(tree_ancestor_mask(np.asarray(parent)), device=dev)
        depth = anc.sum(dim=-1).to(torch.int32) - 1
        pos, slots, _ = pos_after(C, T)
        pos[slots.long()] = C + depth
        mask = tree_mask_from_pos(pos, C + depth, anc[None], slots)[:, 0]
        k, v = ring(B, Hkv, C + T)
    elif name == "draft decode":  # one token after 42
        (B, T), (H, Hkv) = (1, 1), hk(16, 4)
        pos, _, qpos = pos_after(42, T)
        mask = attn_mask_from_pos(pos, qpos)[:, 0]
        k, v = ring(B, Hkv, 43)
    elif name == "draft branch step":  # K = 2 forked rows share the (1, T, S) mask
        (B, T), (H, Hkv) = (2, 1), hk(16, 4)
        pos, _, qpos = pos_after(44, T)
        mask = attn_mask_from_pos(pos, qpos)[:, 0]
        k, v = ring(B, Hkv, 45)
    elif name.startswith("batched admission prefill"):  # 8 prompt tokens into a fresh 1-row ring
        B, T = 1, 8
        H, Hkv = hk(*((32, 8) if name.endswith("target") else (16, 4)))
        pos = torch.full((1, S), -1, dtype=torch.int32, device=dev)
        pos[0, :T] = torch.arange(T, dtype=torch.int32, device=dev)
        mask = attn_mask_from_pos(pos, pos[:, :T])[:, 0]
        k, v = ring(B, Hkv, T)
    elif name == "batched draft branch step":  # 8 streams x K = 2 forked dense rows, a mask per row
        (B, T), (H, Hkv) = (16, 1), hk(16, 4)
        n = (43 + 9 * (torch.arange(B, device=dev) // 2)).to(torch.int32)  # each row's new token
        slot = torch.arange(S, dtype=torch.int32, device=dev)[None]
        pos = torch.where(slot <= n[:, None], slot, -1)
        mask = attn_mask_from_pos(pos, n[:, None])[:, 0]
        k, v = ring(B, Hkv, int(n.max()) + 1)
    else:  # random per-row mask with a fully masked row
        (B, T), (H, Hkv) = (2, 7), hk(32, 8)
        mask = torch.rand(B, T, S, generator=gen, device=dev) < 0.5
        mask[1, 3] = False
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    q = torch.randn(B, T, H, D, generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask.contiguous()


CASES = ["target prefill", "target tree pass", "draft decode", "draft branch step",
         "random mask, fully masked row", "batched admission prefill, target",
         "batched admission prefill, draft", "batched draft branch step", "long target tree pass"]
# the MoE pair's heads: target qwen3-moe-235b-a22b (H 64, Hkv 4), its draft (H 32, Hkv 2)
MOE_HEADS = {"target": (64, 4), "draft": (32, 2)}
MOE_CASES = ["target prefill", "target tree pass", "batched admission prefill, target", "draft decode",
             "batched draft branch step", "long target tree pass"]
# The long-cache rows: a 32768-slot ring (or rows of 512 64-slot blocks) after ~30000
# committed tokens, past the tree kernels' split threshold (4096 slots): their split path
LONG_S, LONG_COMMITTED, LONG_NB = 32768, 30000, 512


def _moe_heads(case):
    return MOE_HEADS["target" if "target" in case else "draft"]


# examples/serve_speculative.py's heads (H, Hkv, head_dim): its target's 6/2 of 32, its
# draft's 2/1 of 48 (phase 10d serves them); phase 2 holds kernels 1-3 at both, the split
# path included.  (case, role): the draft's heads also take the long (2, 2, 2) pass
EXAMPLE_HEADS = {"target": (6, 2, 32), "draft": (2, 1, 48)}
EXAMPLE_CASES = [("target prefill", "target"), ("target tree pass", "target"), ("long target tree pass", "target"),
                 ("draft decode", "draft"), ("draft branch step", "draft"), ("long target tree pass", "draft")]
EXAMPLE_PAGED_CASES = [("paged target tree pass", "target"), ("long paged target tree pass", "target"),
                       ("draft trunk", "draft"), ("long paged target tree pass", "draft")]
EXAMPLE_RAGGED_CASES = [(3, "target", False), (8, "target", True), (3, "draft", False), (8, "draft", True)]


def _example(role):
    """(H, Hkv), head_dim and the case label's suffix of the example's ``role`` heads."""
    H, Hkv, D = EXAMPLE_HEADS[role]
    return (H, Hkv), D, f", example {role} heads (D {D})"


def _tree_cases():
    """(case, (H, Hkv) or None, head_dim, label) of phase 2's dense tree rows."""
    return ([(c, None, 128, c) for c in CASES] + [(c, _moe_heads(c), 128, f"{c}, qwen3-moe heads") for c in MOE_CASES]
            + [(c, *_example(r)[:2], c + _example(r)[2]) for c, r in EXAMPLE_CASES])


def phase_kernels(torch):
    log("== phase 2: each kernel against its plain version on the card")
    import torch.nn.functional as F

    from repro_torch.kernels.ref import tree_attention_ref
    from repro_torch.kernels.tree_attention import SPLIT_ABOVE, tree_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = ColdTimer(torch)
    # the least reading a launch can give (events, a launch, a kernel that does nothing)
    floor_ms = timer(lambda: torch.cuda._sleep(0))
    log(f"  ColdTimer floor (a kernel that does nothing): {floor_ms:.4f} ms")
    rows = [{"kernel": "null kernel (ColdTimer floor)", "case": "torch.cuda._sleep(0)", "ms": floor_ms}]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, heads, D, case in _tree_cases():
            q, k, v, mask = _case_inputs(torch, name, dtype, gen, heads, D)
            out = tree_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = tree_attention_ref(q, k, v, mask)
            err, rel = _check_tree(torch, "tree_attention", case, dname, out, ref)
            control = None
            if k.shape[1] > SPLIT_ABOVE:
                control = _dropped_tree_split_control(torch, lambda m: tree_attention_ref(q, k, v, m), mask, ref,
                                                      dname)
            qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
            m4 = mask[:, None]

            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=m4, enable_gqa=True)

            ms = timer(lambda: tree_attention(q, k, v, mask))
            plain_ms = timer(lambda: tree_attention_ref(q, k, v, mask))
            library_ms = timer(sdpa)
            bound_ms, bound_by = attention_bound(q, k, v, mask)
            row = {"kernel": "tree_attention", "case": case, "dtype": dname, "shape": {"B": q.shape[0], "T": q.shape[1], "H": q.shape[2],
                   "Hkv": k.shape[2], "S": k.shape[1], "D": q.shape[3], "Bm": mask.shape[0]},
                   "max_abs_err": err, "max_rel_err": rel, "tolerance": TOLERANCE[dname],
                   "tolerance_rule": TREE_TOLERANCE_RULE, "dropped_split_control": control, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            rows.append(row)
            log(f"  {case:46s} {dname:8s} err {err:.3e} rel {rel:.3e} (tol {TOLERANCE[dname]:.0e})  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})")
            _log_control(control, dname)
        rows += paged_kernel_rows(torch, dtype, gen, timer)
        rows += hybrid_kernel_rows(torch, dtype, gen, timer)
        rows += family_kernel_rows(torch, dtype, gen, timer)
        rows += decode_kernel_rows(torch, dtype, gen, timer)
    rows += decode_alone_rows(torch, gen, timer)
    return rows


# ------------------------------------------------- the batched path's kernels ---

PAGED_CASES = ["paged target tree pass", "draft ingest Dp=1", "draft ingest Dp=2", "draft trunk",
               "unmapped blocks, fully masked row", "long paged target tree pass"]
MOE_PAGED_CASES = ["paged target tree pass", "draft ingest Dp=1", "draft ingest Dp=2", "draft trunk"]
RAGGED_CASES = [3, 8]  # owners of (2, 2, 2) trees in one flat buffer (and 8 on LONG_NB-block rows)
BLOCK, NB = 64, 16


def _paged_pool(torch, gen, dtype, B, Hkv, lengths, T, nb=NB, D=128):
    """A random arena (trash block included), tables mapping each row's
    blocks up to length + T (distinct ids), and per-row pos tables holding
    the committed positions."""
    import numpy as np

    nblk = B * nb + 1
    k = torch.empty(nblk, BLOCK, Hkv, D, device="cuda", dtype=dtype).normal_(generator=gen)
    v = torch.empty(nblk, BLOCK, Hkv, D, device="cuda", dtype=dtype).normal_(generator=gen)
    ids = (torch.randperm(nblk - 1, generator=gen, device="cuda") + 1).reshape(B, nb).cpu().numpy()
    tbl = np.full((B, nb), -1, np.int32)
    pos = np.full((B, nb * BLOCK), -1, np.int32)
    for b, n in enumerate(lengths):
        need = -(-(n + T) // BLOCK)
        tbl[b, :need] = ids[b, :need]
        pos[b, :n] = np.arange(n)
    return k, v, torch.as_tensor(tbl, device="cuda"), torch.as_tensor(pos, device="cuda")


def _paged_case_inputs(torch, name, dtype, gen, heads=None, D=128):
    """(q, k_arena, v_arena, tbl, mask) of the padded paged pass at one of the
    batched path's shapes, masks made by the port's own cache functions;
    ``heads`` = (H, Hkv) replaces the granite pair's (head_dim ``D``)."""
    from repro_torch.models.cache import attn_mask_from_pos, cache_slots, tree_mask_from_pos
    from repro_torch.serving.serve_step import device_ancestor_mask

    B = 8
    long = name.startswith("long")
    nb = LONG_NB if long else NB
    S = nb * BLOCK
    lengths = [(LONG_COMMITTED + 97 * b) if long else (40 + 9 * b) for b in range(B)]
    if name in ("paged target tree pass", "unmapped blocks, fully masked row", "long paged target tree pass"):
        T, H, Hkv = 7, 32, 8
    else:
        T = {"draft ingest Dp=1": 1, "draft ingest Dp=2": 2, "draft trunk": 1}[name]
        H, Hkv = 16, 4
    H, Hkv = heads or (H, Hkv)
    k, v, tbl, pos = _paged_pool(torch, gen, dtype, B, Hkv, lengths, T, nb, D)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    slots = cache_slots(length, T, S)
    bidx = torch.arange(B, device="cuda")[:, None]
    if T == 7:
        parents = torch.tensor([[-1, 0, 1, 2, 2, 3, 4]] * B, dtype=torch.int32, device="cuda")
        anc = device_ancestor_mask(parents)
        qpos = length[:, None] + anc.sum(dim=-1).to(torch.int32) - 1
        pos[bidx, slots.long()] = qpos
        mask = tree_mask_from_pos(pos, qpos, anc, slots)[:, 0]
    else:
        lens = torch.tensor([1 + b % T for b in range(B)], device="cuda")
        qpos = length[:, None] + torch.arange(T, dtype=torch.int32, device="cuda")
        pos[bidx, slots.long()] = torch.where(torch.arange(T, device="cuda") < lens[:, None], qpos, -1)
        mask = attn_mask_from_pos(pos, qpos)[:, 0]
    if name == "unmapped blocks, fully masked row":
        tbl[1:, 1:] = -1  # unmapped logical blocks read the trash block
        mask = torch.rand(B, T, S, generator=gen, device="cuda") < 0.05
        mask[:, :, BLOCK:] &= (torch.arange(B, device="cuda") == 0)[:, None, None]
        mask[2, 3] = False
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    return q, k, v, tbl, mask.contiguous()


def _ragged_case_inputs(torch, owners, dtype, gen, heads=(32, 8), long=False, D=128):
    """(q, k_arena, v_arena, tbl, owner, mask) of the ragged pass: ``owners``
    (2, 2, 2) trees of 7 nodes packed back to back into Npad (a power of two)
    lanes, padding lanes as forward passes them to the kernel (owner -1).
    ``long``: rows of LONG_NB blocks after ~LONG_COMMITTED tokens."""
    import numpy as np

    from repro_torch.models.cache import ragged_tree_mask
    from repro_torch.serving.serve_step import next_pow2

    B = 8
    nb = LONG_NB if long else NB
    S = nb * BLOCK
    lengths = [(LONG_COMMITTED + 97 * b) if long else (40 + 9 * b) for b in range(B)]
    H, Hkv = heads
    k, v, tbl, pos = _paged_pool(torch, gen, dtype, B, Hkv, lengths, 7, nb, D)
    n = 7 * owners
    npad = next_pow2(n)
    parent1, depth1 = np.array([-1, 0, 1, 2, 2, 3, 4]), np.array([0, 1, 2, 3, 3, 4, 4])
    owner = np.zeros(npad, np.int32)
    parent = np.full(npad, -1, np.int32)
    depth = np.zeros(npad, np.int32)
    local = np.full(npad, -1, np.int32)
    for i in range(owners):
        o = 7 * i
        owner[o:o + 7] = 7 - i  # rows in the engine's order are sorted; any order is legal
        parent[o:o + 7] = np.where(parent1 >= 0, o + parent1, -1)
        depth[o:o + 7] = depth1
        local[o:o + 7] = np.arange(7)
    owner_t, parent_t, depth_t, local_t = (torch.as_tensor(a, device="cuda") for a in (owner, parent, depth, local))
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q_pos = length[owner_t.long()] + depth_t
    slots = torch.where(local_t >= 0, (length[owner_t.long()] + local_t.clamp_min(0)) % S, S)
    real = local_t >= 0
    pos[owner_t.long()[real], slots.long()[real]] = q_pos[real]
    mask = ragged_tree_mask(pos, q_pos, owner_t, slots, parent_t)
    q = torch.randn(npad, H, D, generator=gen, device="cuda").to(dtype)
    return q, k, v, tbl, torch.where(real, owner_t, -1), mask.contiguous()


# (case, layers, KV heads, rows, entries a row) of the arenas the commits of phases 4 and 5
# move, and the 36-layer arena at 3072 entries (64 rows x 48), the most an earlier
# commit_kv took (the card tests hold the kernel at its own cap, MAX_ENTRIES)
COMMIT_ARENAS = [("36-layer arena", 36, 8, 8, 4), ("qwen3-moe target arena, 8 layers, Hkv 4", 8, 4, 8, 4),
                 ("qwen3-moe draft arena, 23 layers, Hkv 2", 23, 2, 8, 4),
                 ("36-layer arena, 64 rows, 3072 entries", 36, 8, 64, 48)]


def _commit_case_inputs(torch, dtype, gen, L, Hkv, B, P):
    """The fused commit of an L-layer arena (B rows x 16 blocks of 64 slots,
    Hkv KV heads of 128): B rows x P entries translated through the tables,
    as make_pool_commit_step stages them.  The first 5/8 of the rows accept
    the chain [2, 3, ..., P] (entry j's source is entry j+1's destination)
    and pad with the root's identity copy; the other rows are idle, their
    tables unmapped, so their entries are identity copies of one trash
    lane."""
    from repro_torch.models.cache import paged_phys_slots

    k = torch.randn(L, B * NB + 1, BLOCK, Hkv, 128, generator=gen, device="cuda").to(dtype)
    v = torch.randn(L, B * NB + 1, BLOCK, Hkv, 128, generator=gen, device="cuda").to(dtype)
    tbl = (torch.randperm(B * NB, generator=gen, device="cuda") + 1).reshape(B, NB).to(torch.int32)
    busy = 5 * B // 8
    tbl[busy:] = -1
    C = torch.tensor([40 + 9 * b if b < busy else 0 for b in range(B)], device="cuda")
    j = torch.arange(P, device="cuda")
    path = torch.where(j < P - 1, j + 2, 0)
    valid = (j[None, :] < P - 1) & (torch.arange(B, device="cuda") < busy)[:, None]
    src = torch.where(valid, C[:, None] + path, C[:, None])
    dst = torch.where(valid, C[:, None] + 1 + j, C[:, None])
    srcf = paged_phys_slots(tbl, src, BLOCK).reshape(1, -1).to(torch.int32)
    dstf = paged_phys_slots(tbl, dst, BLOCK).reshape(1, -1).to(torch.int32)
    kf = k.view(L, 1, -1, Hkv, 128)
    vf = v.view(L, 1, -1, Hkv, 128)
    return kf, vf, srcf, dstf


def _row_errs(out, ref):
    """(max|out - ref|, max|ref|) of each batch row."""
    return ((out.float() - ref.float()).abs().flatten(1).amax(dim=1), ref.float().abs().flatten(1).amax(dim=1))


def _check_tree(torch, kernel, case, dname, out, ref):
    """Hold a tree kernel's (..., H, D) output to TREE_TOLERANCE_RULE; returns
    (max abs err, max over query rows of the row's err / its largest |ref|,
    rows with no scale of their own, padding lanes, left out of the ratio)."""
    diff, scale = _row_errs(out.flatten(0, -3), ref.flatten(0, -3))
    err, has = diff.max().item(), scale > 0
    rel = (diff[has] / scale[has]).max().item() if bool(has.any()) else 0.0
    if (not torch.isfinite(out).all() or err > TOLERANCE[dname]
            or not bool((diff <= TOLERANCE[dname] * scale).all())):
        raise RuntimeError(f"{kernel} disagrees with its plain version: {case} {dname} max abs err {err}, "
                           f"max err / max|ref| of a query row {rel} (tolerance {TOLERANCE[dname]}; or not finite)")
    return err, rel


def _dropped_tree_split_control(torch, plain, mask, want, dname):
    """The tree check's sensitivity on a long cache: ``plain(mask)`` with the
    first split's slots [0, SPLIT_SLOTS) left out of the mask, as a kernel
    that lost that split would give.  Returns the smallest err / max|ref|
    over the query rows that admitted a key there; it must exceed
    TOLERANCE, or the check could not see such a fault."""
    from repro_torch.kernels.tree_attention import SPLIT_SLOTS

    cut = mask.clone()
    cut[..., :SPLIT_SLOTS] = False
    diff, scale = _row_errs(plain(cut).flatten(0, -3), want.flatten(0, -3))
    lost = mask[..., :SPLIT_SLOTS].any(dim=-1).expand(want.shape[:-2]).reshape(-1) & (scale > 0)
    rel = (diff[lost] / scale[lost]).min().item()
    if not rel > TOLERANCE[dname]:
        raise RuntimeError(f"the tree check cannot see a dropped {SPLIT_SLOTS}-slot split ({dname}): {rel}")
    return rel


def _log_control(control, dname):
    if control is not None:
        log(f"    control: the first split's keys left out give err / max|ref| >= {control:.3e} in every query "
            f"row that admitted one (tolerance {TOLERANCE[dname]:.0e})")


def _log_wrapper(wrapper):
    """The host time and the reading without the spin kernel, where timed."""
    if "host_ms" not in wrapper:
        return ""
    return f"  host {wrapper['host_ms']:.4f} ms  unspun {wrapper['unspun_ms']:.4f} ms"


def _check_decode(torch, kernel, case, dname, out, ref):
    """Hold a flash-decode output to DECODE_TOLERANCE_RULE; returns (max abs
    err, max over rows of the row's err / its largest |ref|)."""
    diff, scale = _row_errs(out, ref)
    rel = (diff / scale).max().item()
    if not torch.isfinite(out).all() or not bool((diff <= TOLERANCE[dname] * scale).all()):
        raise RuntimeError(f"{kernel} disagrees with its plain version: {case} {dname} max err / max|ref| "
                           f"of a row {rel} > {TOLERANCE[dname]} (or not finite)")
    return diff.max().item(), rel


def _dropped_split_control(torch, q, k, v, lengths, want, dname, split=512):
    """The check's sensitivity: the plain version with the first ``split``
    valid slots of every row left out, as a kernel that lost one split of
    that size would give.  Returns the smallest err / max|ref| over the rows
    that keep slots; it must exceed TOLERANCE, or the check could not see
    such a fault."""
    from repro_torch.kernels.ref import tree_attention_ref

    slot = torch.arange(k.shape[1], device=q.device)[None, :]
    ln = lengths.long()[:, None]
    kept = (slot >= split) & (slot < ln)
    diff, scale = _row_errs(tree_attention_ref(q, k, v, kept[:, None, :]), want)
    rel = (diff / scale)[lengths > split].min().item()
    if not rel > TOLERANCE[dname]:
        raise RuntimeError(f"the decode check cannot see a dropped {split}-slot split ({dname}): {rel}")
    return rel


def paged_kernel_rows(torch, dtype, gen, timer):
    """The batched path's three kernels at its shapes, in one dtype."""
    import torch.nn.functional as F

    from repro_torch.kernels.commit_kv import commit_kv
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention
    from repro_torch.kernels.ref import (
        commit_kv_ref,
        paged_gather_kv_ref,
        paged_tree_attention_ref,
        ragged_tree_attention_ref,
    )
    from repro_torch.kernels.tree_attention import SPLIT_ABOVE

    dname = str(dtype).replace("torch.", "")
    rows = []

    def record(kernel, case, shape, err, ms, plain_ms, composed_ms, composed, bound, rel=None, control=None):
        wrapper = ms if isinstance(ms, dict) else {"ms": ms}  # commit_kv: timer.wrapper's readings
        rows.append({"kernel": kernel, "case": case, "dtype": dname, "shape": shape, "max_abs_err": err,
                     "tolerance": TOLERANCE[dname], **wrapper, "plain_ms": plain_ms, "library_ms": None,
                     "composed_ms": composed_ms, "composed_of": composed, "bound_ms": bound[0],
                     "bound_by": bound[1]}
                    | ({} if rel is None else {"max_rel_err": rel, "tolerance_rule": TREE_TOLERANCE_RULE,
                                               "dropped_split_control": control}))
        log(f"  {kernel} {case:50s} {dname:8s} err {err:.3e}" + ("" if rel is None else f" rel {rel:.3e}")
            + f"  kernel {wrapper['ms']:.4f} ms  plain {plain_ms:.4f} ms  {composed} {composed_ms:.4f} ms  "
            f"bound {bound[0]:.5f} ms ({bound[1]})" + _log_wrapper(wrapper))
        _log_control(control, dname)

    paged_cases = ([(c, None, 128, c) for c in PAGED_CASES]
                   + [(c, _moe_heads(c), 128, f"{c}, qwen3-moe heads") for c in MOE_PAGED_CASES]
                   + [(c, *_example(r)[:2], c + _example(r)[2]) for c, r in EXAMPLE_PAGED_CASES])
    for name, heads, D, case in paged_cases:
        q, k, v, tbl, mask = _paged_case_inputs(torch, name, dtype, gen, heads, D)
        out = paged_tree_attention(q, k, v, tbl, mask)
        torch.cuda.synchronize()
        want = paged_tree_attention_ref(q, k, v, tbl, mask)
        err, rel = _check_tree(torch, "paged_tree_attention", case, dname, out, want)
        control = None
        if mask.shape[-1] > SPLIT_ABOVE:
            control = _dropped_tree_split_control(torch, lambda m: paged_tree_attention_ref(q, k, v, tbl, m), mask,
                                                  want, dname)
        del want
        B, T, H, D = q.shape

        def composed():
            kd, vd = paged_gather_kv_ref(k, v, tbl)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                                                  attn_mask=mask[:, None], enable_gqa=True)

        rmask = mask.expand(B, T, mask.shape[-1]).reshape(B * T, -1)
        group = torch.arange(B, device="cuda").repeat_interleave(T)
        bound = rows_bound(torch, q.reshape(B * T, H, D), rmask, group, B, k.shape[2],
                           mask.numel() + tbl.numel() * 4)
        record("paged_tree_attention", case,
               {"B": B, "T": T, "H": H, "Hkv": k.shape[2], "D": D, "block": BLOCK, "max_blocks": tbl.shape[1]},
               err, timer(lambda: paged_tree_attention(q, k, v, tbl, mask)),
               timer(lambda: paged_tree_attention_ref(q, k, v, tbl, mask)), timer(composed),
               "gather+sdpa", bound, rel, control)
        del k, v
        torch.cuda.empty_cache()

    ragged_cases = ([(n, (32, 8), False, 128, "") for n in RAGGED_CASES]
                    + [(8, MOE_HEADS["target"], False, 128, ", qwen3-moe heads"), (8, (32, 8), True, 128, "")]
                    + [(n, _example(r)[0], long, *_example(r)[1:]) for n, r, long in EXAMPLE_RAGGED_CASES])
    for owners, heads, long, D, heads_label in ragged_cases:
        case = f"ragged target pass, {owners} owners{heads_label}" + (f", {LONG_NB}-block rows" if long else "")
        q, k, v, tbl, owner, mask = _ragged_case_inputs(torch, owners, dtype, gen, heads, long, D)
        out = ragged_paged_tree_attention(q, k, v, tbl, owner, mask)
        torch.cuda.synchronize()
        want = ragged_tree_attention_ref(q, k, v, tbl, owner, mask)
        err, rel = _check_tree(torch, "ragged_paged_tree_attention", case, dname, out, want)
        control = None
        if long:
            control = _dropped_tree_split_control(
                torch, lambda m: ragged_tree_attention_ref(q, k, v, tbl, owner, m), mask, want, dname)
        del want
        N, H, D = q.shape

        def composed():  # padding lanes attend over row 0, as in the JAX package
            kd, vd = paged_gather_kv_ref(k, v, tbl[owner.long().clamp_min(0)])
            return F.scaled_dot_product_attention(q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                                                  attn_mask=mask[:, None, None], enable_gqa=True)

        composed_of = "gather+sdpa"
        if long:  # a view per node would not fit in fp32: each owner's row once, SDPA over its 7 nodes
            real_idx = (owner >= 0).nonzero()[:, 0]
            own = owner[real_idx].long().reshape(-1, 7)[:, 0]
            qr, mr = q[real_idx].reshape(-1, 7, H, D).transpose(1, 2), mask[real_idx].reshape(-1, 7, mask.shape[-1])
            composed_of = "gather per owner row+sdpa"

            def composed():
                kd, vd = paged_gather_kv_ref(k, v, tbl[own])
                return F.scaled_dot_product_attention(qr, kd.transpose(1, 2), vd.transpose(1, 2),
                                                      attn_mask=mr[:, None], enable_gqa=True)

        # real lanes only: a padding lane reads nothing and writes zeros
        real = owner >= 0
        n_pad = int((~real).sum())
        bound = rows_bound(torch, q[real], mask[real], owner[real].long(), tbl.shape[0], k.shape[2],
                           mask[real].numel() + tbl.numel() * 4 + owner.numel() * 4
                           + n_pad * H * D * q.element_size())
        record("ragged_paged_tree_attention", case,
               {"Npad": N, "owners": owners, "padding_lanes": n_pad, "H": H, "Hkv": k.shape[2], "D": D, "block": BLOCK, "max_blocks": tbl.shape[1]},
               err, timer(lambda: ragged_paged_tree_attention(q, k, v, tbl, owner, mask)),
               timer(lambda: ragged_tree_attention_ref(q, k, v, tbl, owner, mask)),
               (torch.cuda.empty_cache(), timer(composed))[1], composed_of, bound, rel, control)
        del k, v
        torch.cuda.empty_cache()

    for arena, L, Hkv, B, P in COMMIT_ARENAS:
        case = f"{arena}, B*P = {B * P}, chains + trash padding"
        kf, vf, src, dst = _commit_case_inputs(torch, dtype, gen, L, Hkv, B, P)
        want_k, want_v = commit_kv_ref(kf.clone(), vf.clone(), src, dst)
        got_k, got_v = commit_kv(kf, vf, src, dst)
        torch.cuda.synchronize()
        if not (torch.equal(got_k, want_k) and torch.equal(got_v, want_v)):
            raise RuntimeError(f"commit_kv disagrees with its plain version: {case} {dname}: it must be exact")
        del want_k, want_v
        E = src.numel()
        lane_bytes = kf.shape[3] * kf.shape[4] * kf.element_size()
        # only entries with src != dst move (each names a distinct destination); all are in range
        M = int(torch.unique(dst[src != dst]).numel())
        bound = _bound(2 * 2 * L * M * lane_bytes + 2 * E * 4, 0.0, dtype)

        def composed():
            s, d = src[0].long(), dst[0].long()
            kf.index_copy_(2, d, kf.index_select(2, s))
            vf.index_copy_(2, d, vf.index_select(2, s))

        record("commit_kv", case, {"L": L, "entries": E, "moves": M, "Hkv": kf.shape[3], "hd": kf.shape[4]}, 0.0,
               timer.wrapper(lambda: commit_kv(kf, vf, src, dst)), timer(lambda: commit_kv_ref(kf, vf, src, dst)),
               timer(composed), "index_select+index_copy_", bound)
        del kf, vf
        torch.cuda.empty_cache()
    return rows


# ------------------------------------- the tree kernels at recurrentgemma-2b's heads ---

# recurrentgemma-2b's local attention: 10 query heads of 256 over one KV head, a 2048-slot window;
# its draft's: 10 heads of 128 over one
HYB_HEADS, HYB_WINDOW = (10, 1), 2048
# (kernel, case, B, T, slots, committed length of row 0, head_dim): the single-stream trunk
# and commit passes on the engines' 1024-slot rings, phase 7c's ring past the window and
# its 2600-token prefill (434 query tiles of 6 rows in one batch row at D 256, 217 of 12 at
# D 128), the batched branch replay (8 rows x K 2 forked rows of L2 2 tokens), the draft's
# forked branch step, and paged rows as the batched pool holds them (64-slot blocks), the
# 8-token admission prefill (2 query tiles), short and past the window
HYB_CASES = [("tree_attention", "hybrid trunk pass, 1024-slot ring", 1, 3, 1024, 40, 256),
             ("tree_attention", "hybrid commit pass past the window, 4096-slot ring", 1, 5, 4096, 3000, 256),
             ("tree_attention", "hybrid 7c prefill, 2600 tokens, 4096-slot ring", 1, 2600, 4096, 0, 256),
             ("tree_attention", "hybrid batched branch replay, 16 forked rows", 16, 2, 1024, 40, 256),
             ("tree_attention", "hybrid draft branch step, 2 forked rows, D 128", 2, 1, 1024, 40, 128),
             ("tree_attention", "hybrid draft 7c prefill, 2600 tokens, D 128", 1, 2600, 4096, 0, 128),
             ("paged_tree_attention", "hybrid paged admission prefill, 8 rows", 8, 8, 1024, 0, 256),
             ("paged_tree_attention", "hybrid paged rows, 8 rows", 8, 3, 1024, 40, 256),
             ("paged_tree_attention", "hybrid paged rows past the window, 8 rows", 8, 3, 4096, 3000, 256)]


def _hybrid_case_inputs(torch, B, T, S, C, D, dtype, gen, paged):
    """q, k/v (a dense ring (B, S, 1, D), or an arena of 64-slot blocks and
    tables), and the local-window mask of T new tokens after C + 9 b
    committed ones in row b, made by the port's own cache functions."""
    from repro_torch.models.cache import attn_mask_from_pos

    H, Hkv = HYB_HEADS
    lengths = torch.tensor([C + 9 * b for b in range(B)], device="cuda")
    slot = torch.arange(S, device="cuda")[None]
    pos = torch.where(slot < (lengths + T)[:, None], slot, -1)
    q_pos = lengths[:, None] + torch.arange(T, device="cuda")
    mask = attn_mask_from_pos(pos, q_pos, HYB_WINDOW)[:, 0].contiguous()
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    if not paged:
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
        return q, k, v, None, mask
    nb = S // BLOCK
    k, v = (torch.randn(B * nb + 1, BLOCK, Hkv, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
    tbl = (torch.randperm(B * nb, generator=gen, device="cuda") + 1).reshape(B, nb).to(torch.int32)
    need = (lengths + T + BLOCK - 1) // BLOCK
    tbl = torch.where(torch.arange(nb, device="cuda")[None] < need[:, None], tbl, -1)
    return q, k, v, tbl, mask


def hybrid_kernel_rows(torch, dtype, gen, timer):
    """Kernels 1-2 at recurrentgemma-2b's heads (head_dim 256) and its
    draft's (128) under the window mask, against the plain versions
    (TREE_TOLERANCE_RULE), with their times, bounds and SDPA (dense) or
    gather+SDPA (paged) times."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_tree_attention import paged_tree_attention
    from repro_torch.kernels.ref import paged_gather_kv_ref, paged_tree_attention_ref, tree_attention_ref
    from repro_torch.kernels.tree_attention import tree_attention

    dname = str(dtype).replace("torch.", "")
    rows = []
    for kernel, case, B, T, S, C, D in HYB_CASES:
        paged = kernel == "paged_tree_attention"
        q, k, v, tbl, mask = _hybrid_case_inputs(torch, B, T, S, C, D, dtype, gen, paged)
        if paged:
            def fn():
                return paged_tree_attention(q, k, v, tbl, mask)

            def plain():
                return paged_tree_attention_ref(q, k, v, tbl, mask)

            def library():
                kd, vd = paged_gather_kv_ref(k, v, tbl)
                return F.scaled_dot_product_attention(q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                                                      attn_mask=mask[:, None], enable_gqa=True)
        else:
            def fn():
                return tree_attention(q, k, v, mask)

            def plain():
                return tree_attention_ref(q, k, v, mask)

            def library():
                return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                      attn_mask=mask[:, None], enable_gqa=True)
        out = fn()
        torch.cuda.synchronize()
        err, rel = _check_tree(torch, kernel, case, dname, out, plain())
        H, D = q.shape[2], q.shape[3]
        group = torch.arange(B, device="cuda").repeat_interleave(T)
        extra = mask.numel() + (0 if tbl is None else tbl.numel() * 4)
        bound_ms, bound_by = rows_bound(torch, q.reshape(B * T, H, D), mask.reshape(B * T, S), group, B, 1, extra)
        ms, plain_ms, library_ms = timer(fn), timer(plain), timer(library)
        shape = {"B": B, "T": T, "H": H, "Hkv": 1, "S": S, "D": D, "window": HYB_WINDOW,
                 "live_chunks_row0": int(mask[0].any(dim=0).reshape(-1, 32).any(dim=1).sum())}
        rows.append({"kernel": kernel, "case": case, "dtype": dname, "shape": shape, "max_abs_err": err,
                     "max_rel_err": rel, "tolerance": TOLERANCE[dname], "tolerance_rule": TREE_TOLERANCE_RULE,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": None if paged else library_ms,
                     "composed_ms": library_ms if paged else None, "composed_of": "gather+sdpa" if paged else None,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"  {kernel} {case:52s} {dname:8s} err {err:.3e} rel {rel:.3e}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  {'gather+sdpa' if paged else 'sdpa'} {library_ms:.4f} ms  bound {bound_ms:.5f} ms "
            f"({bound_by})")
        del q, k, v, mask
        torch.cuda.empty_cache()
    return rows


# phase 9's tree-kernel shapes on the 1024-slot ring: whisper-medium's (2, 2, 2) tree pass (16/16
# heads of 64, G 1: 32 score rows a tile, 4 teams), internvl2-26b's (48/8 heads of 128, G 6: gh 6 x
# tq 21 = 126 score rows, the last m16 tile part filled) and its prefill of 256 patches + 7 tokens
# (13 query tiles); (case, H, Hkv, D, T, committed tokens before the pass)
FAMILY_CASES = [("whisper-medium tree pass, 1024-slot ring", 16, 16, 64, 7, 40),
                ("internvl2-26b tree pass, 1024-slot ring", 48, 8, 128, 7, 300),
                ("internvl2-26b prefill, 256 patches + 7 tokens", 48, 8, 128, 263, 0)]


def _family_case_inputs(torch, H, Hkv, D, T, C, dtype, gen):
    """q, a 1024-slot ring (B 1) holding the C committed tokens and the T
    new ones, and the mask the engine gives the pass, made by the port's own
    cache functions: the (2, 2, 2) tree's after C tokens (T 7), or the
    causal prefill's (C 0)."""
    import numpy as np

    from repro_torch.core.trees import tree_ancestor_mask
    from repro_torch.models.cache import attn_mask_from_pos, cache_slots, tree_mask_from_pos

    S, dev = 1024, "cuda"
    pos = torch.full((S,), -1, dtype=torch.int32, device=dev)
    pos[:C + T] = torch.arange(C + T, dtype=torch.int32, device=dev)
    if C == 0:
        mask = attn_mask_from_pos(pos, torch.arange(T, dtype=torch.int32, device=dev))[:, 0]
    else:
        anc = torch.as_tensor(tree_ancestor_mask(np.asarray([-1, 0, 1, 2, 2, 3, 4])), device=dev)
        depth = anc.sum(dim=-1).to(torch.int32) - 1
        slots = cache_slots(torch.tensor(C, dtype=torch.int32, device=dev), T, S)
        pos[slots.long()] = C + depth
        mask = tree_mask_from_pos(pos, C + depth, anc[None], slots)[:, 0]
    k = torch.zeros(1, S, Hkv, D, device=dev)
    v = torch.zeros(1, S, Hkv, D, device=dev)
    k[:, :C + T] = torch.randn(1, C + T, Hkv, D, generator=gen, device=dev)
    v[:, :C + T] = torch.randn(1, C + T, Hkv, D, generator=gen, device=dev)
    q = torch.randn(1, T, H, D, generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask.contiguous()


def family_kernel_rows(torch, dtype, gen, timer):
    """Kernel 1 at phase 9's heads (FAMILY_CASES) against its plain version
    (TREE_TOLERANCE_RULE), with its time, bound and SDPA's."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import tree_attention_ref
    from repro_torch.kernels.tree_attention import launch_schedule, tree_attention

    dname = str(dtype).replace("torch.", "")
    rows = []
    for case, H, Hkv, D, T, C in FAMILY_CASES:
        q, k, v, mask = _family_case_inputs(torch, H, Hkv, D, T, C, dtype, gen)
        out = tree_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err, rel = _check_tree(torch, "tree_attention", case, dname, out, tree_attention_ref(q, k, v, mask))
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask[:, None], enable_gqa=True)

        ms = timer(lambda: tree_attention(q, k, v, mask))
        plain_ms = timer(lambda: tree_attention_ref(q, k, v, mask))
        library_ms = timer(sdpa)
        bound_ms, bound_by = attention_bound(q, k, v, mask)
        tq, gh, _, _ = launch_schedule(H, Hkv, k.shape[1], D)
        shape = {"B": 1, "T": T, "H": H, "Hkv": Hkv, "S": k.shape[1], "D": D, "Bm": 1, "tq": tq, "gh": gh,
                 "query_tiles": -(-T // tq)}
        rows.append({"kernel": "tree_attention", "case": case, "dtype": dname, "shape": shape, "max_abs_err": err,
                     "max_rel_err": rel, "tolerance": TOLERANCE[dname], "tolerance_rule": TREE_TOLERANCE_RULE,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        log(f"  tree_attention {case:46s} {dname:8s} err {err:.3e} rel {rel:.3e}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})  gh {gh} x tq {tq}")
        del q, k, v, mask
    return rows


# ---------------------------------------------------- the flash-decode kernels ---

DECODE_S = 32768  # decode_32k's cache (src/repro/launch/shapes.py:25)
DECODE_WINDOW = 8192  # long_500k's sliding-window variant (shapes.py:39-40)
# G 4, 8 and 16: the bf16 kernel's tile of 16 query heads padded, half padded, full
DECODE_HEADS = {"granite-8b heads": (32, 8), "llama-3-70b heads": (64, 8), "qwen3-moe heads": (64, 4)}
DECODE_VARIANTS = [(0, False), (DECODE_WINDOW, False), (0, True), (DECODE_WINDOW, True)]  # (window, a row at 0)
# the other head_dims the repo's models use: examples/serve_speculative.py's target (6 heads over 2 of 32) and
# draft (2 over 1 of 48), and recurrentgemma-2b's local attention (10 over 1 of 256, its 2048-slot window),
# each on a 4096-slot cache (recurrentgemma's 7c ring), with and without a window: (heads, H, Hkv, D, window)
DECODE_WIDTHS = [("serve_speculative.py target heads", 6, 2, 32, 0),
                 ("serve_speculative.py target heads", 6, 2, 32, 1024),
                 ("serve_speculative.py draft heads", 2, 1, 48, 0),
                 ("serve_speculative.py draft heads", 2, 1, 48, 1024),
                 ("recurrentgemma-2b heads", 10, 1, 256, 0),
                 ("recurrentgemma-2b heads", 10, 1, 256, 2048)]
WIDTH_S = 4096
WIDTH_LENGTHS = [1, 300, 1000, 2047, 2600, 3000, 4000, 4096]  # the paged rows'; below, past and at the window


def _decode_lengths(torch, B, S, zero_row):
    """Mixed per-row lengths spread over [1, S], row 0 at 0 when ``zero_row``."""
    lengths = [max(1, min(S, (S * (b + 1)) // B - 997 * (b % 3))) for b in range(B)]
    if zero_row:
        lengths[0] = 0
    return torch.tensor(lengths, dtype=torch.int32, device="cuda")


def decode_bound(torch, q, kv, lengths, S, window, extra_bytes):
    """Least time (ms) of flash-decode, and what bounds it.  Bytes: q and out
    once, ``extra_bytes`` (tables), the lengths, and each row's valid K and V
    rows once per KV head (all S rows of V where a row has no valid slot:
    its output is the mean of V).  Operations: 2*D per (query head, valid
    key) for QK and as many for PV."""
    B, _, H, D = q.shape
    Hkv = kv.shape[2]
    ln = lengths.long()
    lo = (ln - window).clamp_min(0) if window else torch.zeros_like(ln)
    n = (ln.clamp(max=S) - lo).clamp_min(0)
    rows_v = torch.where(n == 0, torch.full_like(n, S), n)
    nbytes = (2 * q.numel() * q.element_size() + extra_bytes + lengths.numel() * 4
              + float((n + rows_v).sum()) * Hkv * D * kv.element_size())
    ops = float((2 * D * H * (n + rows_v)).double().sum())
    return _bound(nbytes, ops, q.dtype)


def _sdpa_decode(q, k, v, lengths, window):
    """One SDPA call computing flash-decode: the G query heads of a KV head
    become G query rows of that head (q (B, 1, H, D) -> (B, Hkv, G, D)), so
    nothing repeats K/V over heads; the validity mask (B, 1, 1, S) is built
    from the lengths.  Computes the same function only when every length is
    >= 1 (SDPA gives NaN for a row with no valid slot)."""
    import torch
    import torch.nn.functional as F

    B, _, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    slot = torch.arange(S, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = slot < ln
    if window:
        valid = valid & (slot >= ln - window)
    out = F.scaled_dot_product_attention(q.view(B, Hkv, H // Hkv, D), k.transpose(1, 2), v.transpose(1, 2),
                                         attn_mask=valid[:, None, None, :])
    return out.reshape(B, 1, H, D)


def decode_kernel_rows(torch, dtype, gen, timer):
    """Both flash-decode kernels against their plain versions, in one dtype:
    dense at decode_32k's seq (B 16, S 32768) with each of DECODE_HEADS,
    window 0 and 8192, lengths >= 1 (SDPA beside it) or
    with a row at length 0; paged on phase 4's arena (64-slot blocks, 16 per
    row, 8 rows, unmapped tails) and on 8 rows of 512 blocks (32768 slots);
    then both at the head_dims 32, 48 and 256 (DECODE_WIDTHS)."""
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.ref import decode_attention_ref, paged_decode_attention_ref, paged_gather_kv_ref

    dname = str(dtype).replace("torch.", "")
    rows = []

    def record(kernel, case, shape, errs, wrapper, plain_ms, library_ms, composed_ms, bound):
        err, rel = errs
        ms = wrapper["ms"]
        rows.append({"kernel": kernel, "case": case, "dtype": dname, "shape": shape, "max_abs_err": err,
                     "max_rel_err": rel, "tolerance": TOLERANCE[dname], "tolerance_rule": DECODE_TOLERANCE_RULE,
                     **wrapper, "plain_ms": plain_ms, "library_ms": library_ms,
                     "composed_ms": composed_ms, "composed_of": None if composed_ms is None else "gather+sdpa",
                     "bound_ms": bound[0], "bound_by": bound[1]})
        other = (f"sdpa {library_ms:.4f} ms" if library_ms is not None else
                 f"gather+sdpa {composed_ms:.4f} ms" if composed_ms is not None else "no sdpa (a length-0 row)")
        log(f"  {kernel} {case:58s} {dname:8s} err {err:.3e} (/max|ref| {rel:.2e})  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  {other}  bound {bound[0]:.5f} ms ({bound[1]})" + _log_wrapper(wrapper))

    B, S = 16, DECODE_S
    for heads_name, (H, Hkv) in DECODE_HEADS.items():
        k = torch.randn(B, S, Hkv, 128, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, Hkv, 128, generator=gen, device="cuda").to(dtype)
        q = torch.randn(B, 1, H, 128, generator=gen, device="cuda").to(dtype)
        for window, zero_row in DECODE_VARIANTS:
            lengths = _decode_lengths(torch, B, S, zero_row)
            case = (f"decode_32k, {heads_name}, window {window}, "
                    + ("a row at length 0" if zero_row else "lengths >= 1"))
            out = decode_attention(q, k, v, lengths, window=window)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, lengths, window)
            err = _check_decode(torch, "decode_attention", case, dname, out, want)
            if window == 0 and not zero_row:
                control = _dropped_split_control(torch, q, k, v, lengths, want, dname)
                log(f"  control: one 512-slot split left out gives err / max|ref| >= {control:.3e} in every row "
                    f"(tolerance {TOLERANCE[dname]:.0e})")
            del want
            if zero_row:
                mean_v = v[0].float().mean(dim=0).repeat_interleave(H // Hkv, dim=0)
                _check_decode(torch, "decode_attention", case + " (the mean of V)", dname, out[:1, 0], mean_v[None])
            library_ms = None if zero_row else timer(lambda: _sdpa_decode(q, k, v, lengths, window))
            record("decode_attention", case, {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": 128, "window": window},
                   err, timer.wrapper(lambda: decode_attention(q, k, v, lengths, window=window)),
                   timer(lambda: decode_attention_ref(q, k, v, lengths, window)), library_ms, None,
                   decode_bound(torch, q, k, lengths, S, window, 0))
        del k, v

    paged_cases = [  # (case, heads, rows, blocks per row, lengths, window)
        ("phase 4 arena, unmapped tails, a row at length 0", "granite-8b heads", 8, NB,
         [0, 1, 40, 130, 500, 777, 1000, 1024], 0),
        ("phase 4 arena, unmapped tails, lengths >= 1", "granite-8b heads", 8, NB,
         [1, 40, 76, 130, 500, 777, 1000, 1024], 0),
        ("phase 4 arena, unmapped tails, lengths >= 1", "qwen3-moe heads", 8, NB,
         [1, 40, 76, 130, 500, 777, 1000, 1024], 0),
        ("512-block rows, lengths >= 1", "granite-8b heads", 8, 512,
         [1, 3000, 8192, 12001, 20000, 27777, 32767, 32768], 0),
        ("512-block rows, window 8192, a row at length 0", "granite-8b heads", 8, 512,
         [0, 3000, 8192, 12001, 20000, 27777, 32767, 32768], DECODE_WINDOW),
    ]
    for case, heads_name, Bp, nb, lens, window in paged_cases:
        H, Hkv = DECODE_HEADS[heads_name]
        nblk = Bp * nb + 1
        k = torch.randn(nblk, BLOCK, Hkv, 128, generator=gen, device="cuda").to(dtype)
        v = torch.randn(nblk, BLOCK, Hkv, 128, generator=gen, device="cuda").to(dtype)
        tbl = (torch.randperm(nblk - 1, generator=gen, device="cuda") + 1).reshape(Bp, nb).to(torch.int32)
        for b, n in enumerate(lens):
            tbl[b, -(-n // BLOCK):] = -1  # blocks past the row's length are unmapped (the trash block)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(Bp, 1, H, 128, generator=gen, device="cuda").to(dtype)
        case = f"{case}, {heads_name}"
        out = paged_decode_attention(q, k, v, tbl, lengths, window=window)
        torch.cuda.synchronize()
        err = _check_decode(torch, "paged_decode_attention", case, dname, out,
                            paged_decode_attention_ref(q, k, v, tbl, lengths, window))

        def composed():
            kd, vd = paged_gather_kv_ref(k, v, tbl)
            return _sdpa_decode(q, kd, vd, lengths, window)

        zero_row = min(lens) == 0
        record("paged_decode_attention", case,
               {"B": Bp, "H": H, "Hkv": Hkv, "D": 128, "block": BLOCK, "max_blocks": nb, "window": window},
               err, timer.wrapper(lambda: paged_decode_attention(q, k, v, tbl, lengths, window=window)),
               timer(lambda: paged_decode_attention_ref(q, k, v, tbl, lengths, window)), None,
               None if zero_row else timer(composed),
               decode_bound(torch, q, k, lengths, nb * BLOCK, window, tbl.numel() * 4))
        del k, v

    # the head_dims 32, 48 and 256: dense (B 16, lengths >= 1, SDPA beside it) and paged (8 rows of
    # WIDTH_S / BLOCK blocks, unmapped tails, gather+SDPA beside it)
    nb = WIDTH_S // BLOCK
    for heads_name, H, Hkv, D, window in DECODE_WIDTHS:
        k = torch.randn(B, WIDTH_S, Hkv, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, WIDTH_S, Hkv, D, generator=gen, device="cuda").to(dtype)
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
        lengths = _decode_lengths(torch, B, WIDTH_S, False)
        case = f"S {WIDTH_S}, {heads_name}, D {D}, window {window}, lengths >= 1"
        out = decode_attention(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        err = _check_decode(torch, "decode_attention", case, dname, out, decode_attention_ref(q, k, v, lengths, window))
        record("decode_attention", case, {"B": B, "H": H, "Hkv": Hkv, "S": WIDTH_S, "D": D, "window": window},
               err, timer.wrapper(lambda: decode_attention(q, k, v, lengths, window=window)),
               timer(lambda: decode_attention_ref(q, k, v, lengths, window)),
               timer(lambda: _sdpa_decode(q, k, v, lengths, window)), None,
               decode_bound(torch, q, k, lengths, WIDTH_S, window, 0))
        Bp = len(WIDTH_LENGTHS)
        nblk = Bp * nb + 1
        k = torch.randn(nblk, BLOCK, Hkv, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(nblk, BLOCK, Hkv, D, generator=gen, device="cuda").to(dtype)
        tbl = (torch.randperm(nblk - 1, generator=gen, device="cuda") + 1).reshape(Bp, nb).to(torch.int32)
        for b, n in enumerate(WIDTH_LENGTHS):
            tbl[b, -(-n // BLOCK):] = -1
        lengths = torch.tensor(WIDTH_LENGTHS, dtype=torch.int32, device="cuda")
        q = torch.randn(Bp, 1, H, D, generator=gen, device="cuda").to(dtype)
        case = f"{nb}-block rows, {heads_name}, D {D}, window {window}, unmapped tails, lengths >= 1"
        out = paged_decode_attention(q, k, v, tbl, lengths, window=window)
        torch.cuda.synchronize()
        err = _check_decode(torch, "paged_decode_attention", case, dname, out,
                            paged_decode_attention_ref(q, k, v, tbl, lengths, window))

        def composed():
            kd, vd = paged_gather_kv_ref(k, v, tbl)
            return _sdpa_decode(q, kd, vd, lengths, window)

        record("paged_decode_attention", case,
               {"B": Bp, "H": H, "Hkv": Hkv, "D": D, "block": BLOCK, "max_blocks": nb, "window": window},
               err, timer.wrapper(lambda: paged_decode_attention(q, k, v, tbl, lengths, window=window)),
               timer(lambda: paged_decode_attention_ref(q, k, v, tbl, lengths, window)), None, timer(composed),
               decode_bound(torch, q, k, lengths, WIDTH_S, window, tbl.numel() * 4))
        del k, v
    torch.cuda.empty_cache()
    return rows


def decode_alone_rows(torch, gen, timer):
    """Dense flash-decode alone at B 128, S 32768, granite-8b heads, bf16:
    17.2 GB of K/V, so every byte comes from HBM.  A plain version that
    repeats K/V over heads would need ~69 GB here, so none runs: the kernel
    is checked against SDPA (same function: every length >= 1)."""
    from repro_torch.kernels.decode_attention import decode_attention

    log("  decode_attention alone, B 128, S 32768, granite-8b heads, bf16")
    B, S, (H, Hkv) = 128, DECODE_S, DECODE_HEADS["granite-8b heads"]
    k = torch.empty(B, S, Hkv, 128, device="cuda", dtype=torch.bfloat16).normal_(generator=gen)
    v = torch.empty(B, S, Hkv, 128, device="cuda", dtype=torch.bfloat16).normal_(generator=gen)
    q = torch.randn(B, 1, H, 128, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = (S // 2 + torch.randint(0, S // 2 + 1, (B,), generator=gen, device="cuda")).to(torch.int32)
    case = "alone, B 128, lengths in [S/2, S], granite-8b heads, window 0"
    out = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    err, rel = _check_decode(torch, "decode_attention", case, "bfloat16", out, _sdpa_decode(q, k, v, lengths, 0))
    wrapper = timer.wrapper(lambda: decode_attention(q, k, v, lengths))
    library_ms = timer(lambda: _sdpa_decode(q, k, v, lengths, 0))
    bound = decode_bound(torch, q, k, lengths, S, 0, 0)
    log(f"  decode_attention {case} err vs sdpa {err:.3e} (/max|ref| {rel:.2e})  kernel {wrapper['ms']:.4f} ms  "
        f"sdpa {library_ms:.4f} ms  bound {bound[0]:.5f} ms ({bound[1]}), {2 * k.numel() * 2 / 1e9:.1f} GB of K/V "
        "stored" + _log_wrapper(wrapper))
    del k, v
    torch.cuda.empty_cache()
    return [{"kernel": "decode_attention", "case": case, "dtype": "bfloat16",
             "shape": {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": 128, "window": 0}, "max_abs_err": err,
             "max_rel_err": rel, "max_abs_err_against": "sdpa", "tolerance": TOLERANCE["bfloat16"],
             "tolerance_rule": DECODE_TOLERANCE_RULE, **wrapper, "plain_ms": None,
             "library_ms": library_ms, "composed_ms": None, "bound_ms": bound[0], "bound_by": bound[1]}]


def _run_engine(torch, eng, prompts, max_new, n_layers, actions=None, gen_kw=None):
    """Serve the prompts with the launch count set to 0 just before and
    read just after; check it equals masked passes x layers (prefills,
    draft and target passes, peeks).  ``actions``: the ActionLog of the
    engine's selector, whose deepest tree bounds the block efficiency (else
    the engine's static action does).  ``gen_kw``: each request's
    ``generate`` keywords (phase 9's frames or patches)."""
    from repro_torch.kernels.tree_attention import tree_attention

    vocab = eng.tc.vocab
    torch.cuda.synchronize()
    tree_attention.launches = 0
    t0 = time.perf_counter()
    outs = [eng.generate(p, max_new=max_new, **(gen_kw or {})) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tree_attention.launches
    c = eng.counters
    n_tgt, n_drf = n_layers  # attention layers (0 for an SSM)
    # the replay strategy's commit re-advance is a target pass target_calls does not count
    commits = c["blocks"] if eng.strategy == "replay" else 0
    expected = n_tgt * (len(prompts) + c["target_calls"] + commits) + n_drf * (len(prompts) + c["draft_calls"])
    if launches != expected or (expected and launches == 0):
        raise RuntimeError(f"tree_attention launched {launches} times, expected {expected} "
                           "(masked attention passes x layers)")
    for out in outs:
        if len(out) != max_new or not all(0 <= t < vocab for t in out):
            raise RuntimeError(f"bad output tokens: {out}")
    be = c["accepted"] / max(c["blocks"], 1) + 1
    deepest = max(a[1] + a[2] for acts in actions.by_step.values() for a in acts) if actions else \
        eng.ecfg.L1 + eng.ecfg.L2
    if not 1.0 <= be <= 1 + deepest:
        raise RuntimeError(f"block efficiency {be} outside [1, {1 + deepest}]")
    return outs, wall, launches, be


# device kernels of each tree-kernel row, by name (a split call adds its combine kernel);
# the padded and the ragged entry run the same paged_attention_kernel
PROFILE_KERNELS = {"tree_attention": ("tree_attention_kernel", "tree_attention_combine_kernel"),
                   "paged_tree_attention + ragged_paged_tree_attention":
                       ("paged_attention_kernel", "paged_attention_combine_kernel"),
                   "commit_kv": ("commit_kv_kernel",)}
PROFILE_WRAPPERS = {"tree_attention": ("tree_attention",),
                    "paged_tree_attention + ragged_paged_tree_attention":
                        ("paged_tree_attention", "ragged_paged_tree_attention"),
                    "commit_kv": ("commit_kv",)}


def _kernel_times(by_name, wrapper_launches):
    """{row: {"ms", "launches", "us_per_launch"}}: each tree-kernel row's
    device time in a profiled window, its wrapper calls in that window, and
    the in-engine device time per call."""
    out = {}
    for row, names in PROFILE_KERNELS.items():
        ms = sum(t for n, t in by_name.items() if any(k in n for k in names))
        n = sum(wrapper_launches[w] for w in PROFILE_WRAPPERS[row])
        out[row] = {"ms": ms, "launches": n, "us_per_launch": 1e3 * ms / n if n else None}
    return out


def _profile(torch, eng, prompt, gen_kw=None, labels=()):
    """Where the time goes in one request of 16 tokens: device time by
    kernel from torch.profiler (CUPTI), and the device's busy share of the
    profiled wall time (the profiler's own host cost inflates that wall).
    ``gen_kw``: ``generate``'s keywords; ``labels``: record_function
    ranges whose kernels' device time (theirs and their children's) is
    reported as ``ranges_ms``.  A range's own device span (the profiler's
    annotation of it on the card, idle gaps included) is no kernel: it is
    left out of both."""
    from torch.profiler import ProfilerActivity, profile

    counters = _launch_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompt, max_new=16, **(gen_kw or {}))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    wrapper_launches = {name: fn.launches for name, fn in counters.items()}
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.name not in labels:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    steps = eng.counters["blocks"]
    mine = _kernel_times(by_name, wrapper_launches)
    attn_ms = mine["tree_attention"]["ms"]
    ops = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()]
    launches = sum(n for k, _, n in ops if k in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    log(f"  profile: {steps} steps, wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), kernel launches {launches}, tree_attention {attn_ms:.2f} ms "
        f"({100 * attn_ms / max(busy_ms, 1e-9):.1f} % of busy) in {mine['tree_attention']['launches']} calls, "
        f"{mine['tree_attention']['us_per_launch']:.2f} us a call")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, t in top:
        log(f"    device {t:9.3f} ms  {name[:100]}")
    torch_host_ms = sum(t for _, t, _ in ops)
    log(f"  host: {torch_host_ms:.2f} ms inside torch ops (self CPU time, waits in copies to the host included), "
        f"{wall_ms - torch_host_ms:.2f} ms outside them (Python, numpy verification)")
    host = sorted(ops, key=lambda r: -r[1])[:8]
    for name, t, n in host:
        log(f"    host self {t:9.3f} ms  x{n:<6d} {name[:80]}")
    def kernels_us(evt):
        return sum(k.duration for k in evt.kernels if k.name not in labels) + sum(
            kernels_us(c) for c in evt.cpu_children)

    ranges = {label: sum(kernels_us(e) for e in prof.events() if e.name == label
                         and e.device_type == torch.autograd.DeviceType.CPU) / 1e3 for label in labels}
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms, "tree_attention_ms": attn_ms,
            "launches": launches, "kernel_ms": mine, "torch_host_ms": torch_host_ms, "top_kernels_ms": top,
            "top_host_self_ms": host, "ranges_ms": ranges}


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


def phase_reference(torch, cfg, seed, title="phase 3b: full-width draft", prefill_kw=None):
    """A full-width model ``cfg`` in float32: the card (kernel) against the
    CPU (plain versions), prefill then a (2, 2, 2) tree pass, same weights.
    ``prefill_kw``: the prefill's frames or patches (card tensors); an
    encdec model's cached cross K/V are held with the logits."""
    log(f"== {title} on the card against the CPU, float32")
    import numpy as np

    from repro_torch.core.trees import tree_ancestor_mask
    from repro_torch.models.transformer import forward, init_cache, init_params

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    cpu_params = to_cpu(params)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, size=(1, 7))
    tree_tokens = rng.integers(0, cfg.vocab, size=(1, 7))
    anc = tree_ancestor_mask(np.asarray([-1, 0, 1, 2, 2, 3, 4]))[None]
    worst = 0.0
    sides = {"card": ("cuda", params), "cpu": ("cpu", cpu_params)}
    caches = {side: init_cache(cfg, 1, 1024, dev) for side, (dev, _) in sides.items()}
    cross = "cross_k" in caches["cpu"]
    for mode, toks in (("full", prompt), ("tree", tree_tokens)):
        logits = {}
        for side, (dev, p) in sides.items():
            kw = {k: t.to(dev) for k, t in (prefill_kw or {}).items()} if mode == "full" else {}
            lg, caches[side], _ = forward(p, cfg, torch.as_tensor(toks, device=dev), mode=mode,
                                          cache=caches[side], anc=torch.as_tensor(anc, device=dev)
                                          if mode == "tree" else None, **kw)
            logits[side] = lg.cpu()
        pairs = [(logits["card"], logits["cpu"])]
        if cross:
            pairs += [(caches["card"][leaf].cpu(), caches["cpu"][leaf]) for leaf in ("cross_k", "cross_v")]
        rel = max((a - b).abs().max().item() / max(1.0, b.abs().max().item()) for a, b in pairs)
        worst = max(worst, rel)
        log(f"  {mode}: max |card - cpu| / max(1, max |cpu|) over the logits{' and the cross K/V' if cross else ''}"
            f" = {rel:.3e}")
        if not torch.isfinite(logits["card"]).all() or rel > 1e-3:
            raise RuntimeError(f"{cfg.name} on the card disagrees with the CPU in {mode} mode: {rel}")
    return worst


# --------------------------------------------------------- phase 4: batched ---

N_REQUESTS, N_SLOTS = 12, 8


NO_ENGINE_PATH = ("decode_attention", "paged_decode_attention")  # no engine calls them, as in JAX


def _launch_counters():
    from repro_torch.kernels.commit_kv import commit_kv
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention
    from repro_torch.kernels.tree_attention import tree_attention

    return {"tree_attention": tree_attention, "paged_tree_attention": paged_tree_attention,
            "ragged_paged_tree_attention": ragged_paged_tree_attention, "commit_kv": commit_kv,
            "decode_attention": decode_attention, "paged_decode_attention": paged_decode_attention}


def _serve_batched(torch, eng, prompts, max_new, seeds, layers, actions=None, need_both=True):
    """Serve the requests with every launch count set to 0 just before and
    read just after; check each equals its passes x layers.  ``actions``
    (an ActionLog the engine's selector writes) gives each step's trunk and
    branch depths; without it every step takes the engine's static action.
    ``need_both``: the padded and the ragged tree pass must both have run.
    A ShardedBatchedSpeculativeEngine's counts are summed over its shards:
    each shard step runs its own passes, and a grouped commit is one
    engine-level call that launches commit_kv once a shard."""
    counters = _launch_counters()
    shards = getattr(eng, "shards", None)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    first, last, seen = {}, {}, {}
    commit_groups = 0  # replay: one target pass a shard step for each distinct commit length
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=m, seed=sd) for p, m, sd in zip(prompts, max_new, seeds)]
    routed = [eng.shard_of(r) for r in rids] if shards else None
    owner = dict(zip(rids, routed)) if shards else {}  # requests never migrate
    engine_steps = 0
    while eng.queue or eng.streams:
        ts = time.perf_counter()
        events = eng.step()
        te = time.perf_counter()
        engine_steps += 1
        commit_groups += len({(owner.get(ev["rid"], 0), len(ev["new_tokens"])) for ev in events})
        for ev in events:
            first.setdefault(ev["rid"], ts)
            seen.setdefault(ev["rid"], []).append(len(ev["new_tokens"]))
            if ev["done"]:
                last[ev["rid"]] = te
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    c = eng.counters
    n_tgt, n_drf = layers
    steps = c["target_calls"]
    # each step's trunk steps (the deepest L1 of its batch) and branch steps (the deepest L2)
    levels = actions.levels() if actions is not None else [(eng.ecfg.L1, eng.ecfg.L2)] * steps
    if len(levels) != steps:
        raise RuntimeError(f"the selector chose actions for {len(levels)} steps; the engine ran {steps}")
    trunk, branch = sum(lv[0] for lv in levels), sum(lv[1] for lv in levels)
    if eng.strategy == "replay":
        # every pass but the draft trunk runs on dense rows gathered from the pools: the
        # admission prefills, the draft ingest (one pass per delta length), the branch
        # steps, and the target's trunk and branch groups (target_calls) and commit groups
        steps = c["commit_calls"]
        levels = [(eng.ecfg.L1, eng.ecfg.L2)] * steps
        trunk, branch = steps * eng.ecfg.L1, steps * eng.ecfg.L2
        ingest = c["draft_calls"] - trunk - branch
        if ingest < steps:
            raise RuntimeError(f"{c['draft_calls']} draft calls for {steps} steps of {trunk} trunk and "
                               f"{branch} branch steps: fewer than one ingest a step")
        expected = {
            "tree_attention": n_tgt * (len(prompts) + c["target_calls"] + commit_groups)
            + n_drf * (len(prompts) + ingest + branch),
            # the draft trunk steps on the pool itself
            "paged_tree_attention": n_drf * trunk if eng.paged else 0,
            "ragged_paged_tree_attention": 0,
            "commit_kv": 0,
            **{name: 0 for name in NO_ENGINE_PATH},
        }
        if not eng.paged:
            expected["tree_attention"] += n_drf * trunk
    else:
        # every shard step commits once: alone, or in a grouped commit of all the shards
        commits = (sum(sh.counters["commit_calls"] for sh in shards) + len(shards) * eng.grouped_commits
                   if shards else c["commit_calls"])
        expected = {
            # the admission prefills (target + draft) and the branch steps of every step
            "tree_attention": len(prompts) * (n_tgt + n_drf) + n_drf * branch,
            # ingest and the trunk steps of every step, and the padded target passes
            "paged_tree_attention": n_drf * (steps + trunk) + n_tgt * c["padded_calls"],
            "ragged_paged_tree_attention": n_tgt * c["ragged_calls"],
            "commit_kv": commits,
            **{name: 0 for name in NO_ENGINE_PATH},
        }
        if c["draft_calls"] != steps + trunk + branch or commits != steps:
            raise RuntimeError(f"draft calls {c['draft_calls']}, commit launches {commits} for {steps} steps "
                               f"of {trunk} trunk and {branch} branch steps: expected {steps + trunk + branch} "
                               f"and {steps}")
    for name, want in expected.items():
        if launches[name] != want or (launches[name] == 0 and want and name not in NO_ENGINE_PATH + (
                () if need_both else ("ragged_paged_tree_attention",))):
            raise RuntimeError(f"{name} launched {launches[name]} times, expected {want} (passes x layers)")
    if need_both and not (c["padded_calls"] and c["ragged_calls"]):
        raise RuntimeError(f"padded {c['padded_calls']} and ragged {c['ragged_calls']} tree passes: both must run")
    outs = {rid: eng.finished.pop(rid) for rid in rids}
    vocab = (shards[0] if shards else eng).tc.vocab
    for rid, m in zip(rids, max_new):
        toks = outs[rid]["tokens"]
        if outs[rid]["reason"] != "length" or len(toks) != m or not all(0 <= t < vocab for t in toks):
            raise RuntimeError(f"request {rid}: {outs[rid]['reason']}, {len(toks)} of {m} tokens: {toks}")
    tokens = [outs[r]["tokens"] for r in rids]
    per_stream = [len(t) / (last[r] - first[r]) for r, t in zip(rids, tokens)]
    be = c["accepted"] / max(c["blocks"], 1) + 1
    res = {"wall_s": wall, "tokens": sum(map(len, tokens)), "tokens_per_s": sum(map(len, tokens)) / wall,
           "per_stream_tokens_per_s_median": statistics.median(per_stream),
           "per_stream_tokens_per_s": per_stream, "block_efficiency": be,
           "pad_fraction": c["pad_nodes_total"] / max(c["tree_lanes_total"], 1),
           "blocks_peak": c["blocks_peak"], "steps": steps, "padded_calls": c["padded_calls"],
           "ragged_calls": c["ragged_calls"], "pipeline_ahead": c["pipeline_ahead"],
           "pipeline_stalls": c["pipeline_stalls"], "launches": launches, "expected_launches": expected,
           "commit_calls": c["commit_calls"], "tokens_per_step": [seen[r] for r in rids],
           "engine_steps": engine_steps}
    if shards:
        res["routing"] = routed
        res["grouped_commits"] = eng.grouped_commits
        res["blocks_peak_per_shard"] = [sh.counters["blocks_peak"] for sh in shards]
        res["requests_per_shard"] = [routed.count(i) for i in range(len(shards))]
    return tokens, res


def _profile_batched(torch, eng, prompts, seeds, n_steps, host_ops=True):
    """Device time by kernel and the device's busy share over ``n_steps``
    steps of a full pool (8 resident streams).  ``host_ops`` False traces the
    device only (no host op breakdown; launches are then the device's kernel
    records): the profiler's own processing of a recurrent step's ~30000
    launches and their host ops takes tens of seconds."""
    from torch.profiler import ProfilerActivity, profile

    t_prof = time.perf_counter()
    counters = _launch_counters()
    for p, sd in zip(prompts, seeds):
        eng.submit(p, max_new=48, seed=sd)
    eng.step()  # admission and the first step outside the window
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    wrapper_launches = {name: fn.launches for name, fn in counters.items()}
    eng.abort_pipeline()
    by_name: dict[str, float] = {}
    device_kernels = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            device_kernels += not evt.name.startswith(("Memcpy", "Memset"))
    busy_ms = sum(by_name.values())
    mine = _kernel_times(by_name, wrapper_launches)
    ops = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()] if host_ops else []
    torch_host_ms = sum(t for _, t, _ in ops)
    launches = (sum(n for k, _, n in ops if k in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
                if host_ops else device_kernels)
    log(f"  profile: {n_steps} steps of 8 streams, wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), kernel launches {launches}"
        + ("" if host_ops else " (device kernel records)"))
    for k, r in mine.items():
        per = "" if r["us_per_launch"] is None else f", {r['us_per_launch']:.2f} us a call"
        log(f"    {k:52s} {r['ms']:9.3f} ms ({100 * r['ms'] / max(busy_ms, 1e-9):.1f} % of busy) in "
            f"{r['launches']} calls{per}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, t in top:
        log(f"    device {t:9.3f} ms  {name[:100]}")
    host = sorted(ops, key=lambda r: -r[1])[:8]
    if host_ops:
        log(f"  host: {torch_host_ms:.2f} ms inside torch ops (self CPU time, waits in copies to the host "
            f"included), {wall_ms - torch_host_ms:.2f} ms outside them")
        for name, t, n in host:
            log(f"    host self {t:9.3f} ms  x{n:<6d} {name[:80]}")
    seconds = time.perf_counter() - t_prof
    log(f"  the profile took {seconds:.1f} s (admission and a first step outside the window included)")
    return {"steps": n_steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernel_ms": mine,
            "launches": launches, "launches_from": "cudaLaunchKernel calls" if host_ops else "device kernel records",
            "torch_host_ms": torch_host_ms if host_ops else None, "top_kernels_ms": top, "top_host_self_ms": host,
            "seconds": seconds}


def phase_batched(torch, then=None):
    """Phase 4; ``then(tcfg, tp, dcfg, dp, ctx)`` runs on its models and
    traffic (ctx) before they are freed."""
    log("== phase 4: batched path, full-width granite-8b + draft, bf16, 8 rows, paged, ragged auto")
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine

    tcfg = get_config("granite-8b")
    dcfg = make_draft_cfg(tcfg)
    torch.cuda.reset_peak_memory_stats()
    tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
    dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    layers = (tcfg.n_layers, dcfg.n_layers)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(N_REQUESTS)]
    max_new = [16 + (32 * i) // (N_REQUESTS - 1) for i in range(N_REQUESTS)]
    seeds = [100 + i for i in range(N_REQUESTS)]
    sampling = SamplingParams(1.0, 1.0)

    def engine(pipeline):
        return BatchedSpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024), sampling,
                                        n_slots=N_SLOTS, paged=True, block_size=64, pipeline=pipeline)

    engine(True).generate_batch(prompts[:2], max_new=8, seeds=seeds[:2])  # warm-up, not measured
    results, tokens = {}, {}
    for mode, pipeline in (("pipelined", True), ("sync", False)):
        tokens[mode], results[mode] = _serve_batched(torch, engine(pipeline), prompts, max_new, seeds, layers)
        r = results[mode]
        log(f"  {mode}: {r['tokens']} tokens in {r['wall_s']:.4f} s = {r['tokens_per_s']:.3f} tok/s aggregate, "
            f"per-stream median {r['per_stream_tokens_per_s_median']:.3f} tok/s, block_efficiency "
            f"{r['block_efficiency']:.4f}, pad_fraction {r['pad_fraction']:.4f}, blocks_peak {r['blocks_peak']}, "
            f"steps {r['steps']} (padded {r['padded_calls']}, ragged {r['ragged_calls']}), "
            f"ahead {r['pipeline_ahead']} stalls {r['pipeline_stalls']}, launches {r['launches']}")
    if tokens["pipelined"] != tokens["sync"]:
        bad = [i for i, (a, b) in enumerate(zip(tokens["pipelined"], tokens["sync"])) if a != b]
        raise RuntimeError(f"pipelined tokens differ from synchronous tokens for requests {bad}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  pipelined tokens == sync tokens for all {N_REQUESTS} requests; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    singles = []
    for i in range(3):
        eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=seeds[i]),
                                sampling)
        single = eng.generate(prompts[i], max_new=max_new[i])
        batched = tokens["sync"][i]
        diverge = _first_divergence(single, batched)
        step = None if diverge is None else int(np.searchsorted(
            np.cumsum(results["sync"]["tokens_per_step"][i]), diverge, side="right")) + 1
        singles.append({"request": i, "match": diverge is None, "first_diverging_token": diverge,
                        "first_diverging_step": step})
        log(f"  request {i} through SpeculativeEngine: {'matches' if single == batched else 'differs from'} "
            f"the batched engine token for token"
            + ("" if diverge is None else f" (first diverging token {diverge}, in the stream's step {step}: "
                                          f"{single[diverge]} vs {batched[diverge]})"))
    results["single_stream_matches"] = sum(r["match"] for r in singles)
    results["single_stream"] = singles
    results["max_memory_allocated"] = peak
    # a short window: the whole script keeps within its time budget
    results["profile"] = _profile_batched(torch, engine(True), prompts[:N_SLOTS], seeds[:N_SLOTS], 3)
    if then is not None:
        then(tcfg, tp, dcfg, dp, {"prompts": prompts, "max_new": max_new, "seeds": seeds, "layers": layers,
                                  "tokens": tokens, "results": results})
    del tp, dp
    torch.cuda.empty_cache()
    return results


def _first_divergence(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_batched_reference(torch, cfg, seed, title="phase 4b: batched passes of the full-width draft"):
    """A full-width model ``cfg`` in float32 over a paged pool: one padded
    ingest, one padded tree pass, the fused commit and one ragged tree pass
    on the card (kernels) against the CPU (plain versions), same weights."""
    log(f"== {title} on the card against the CPU, float32")
    import numpy as np

    from repro_torch.models.cache import gather_streams
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serving import serve_step as ss

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    devs = {"cuda": params, "cpu": to_cpu(params)}
    tbl = np.full((3, 16), -1, np.int32)
    tbl[0, :2], tbl[1, :2] = [4, 1], [2, 7]  # row 2 stays idle: its writes go to the trash block
    caches = {}
    for d in devs:
        caches[d] = init_cache(cfg, 3, 1024, d, per_stream=True, page=(48, 64))
        caches[d]["attn"]["block_tbl"] = torch.as_tensor(tbl, device=d)
    rng = np.random.default_rng(2)
    parents = np.asarray([[-1, 0, 1, 2, 2, 3, 4], [-1, 0, 1, 2, 2, 3, 4], [-1] * 7], np.int32)
    ragged = {"owner": np.asarray([1] * 7 + [0] * 7 + [0, 0], np.int32),
              "parent": np.asarray([-1, 0, 1, 2, 2, 3, 4, -1, 7, 8, 9, 9, 10, 11, -1, -1], np.int32),
              "depth": np.asarray([0, 1, 2, 3, 3, 4, 4] * 2 + [0, 0], np.int32),
              "local": np.asarray(list(range(7)) * 2 + [-1, -1], np.int32),
              "counts": np.asarray([7, 7, 0], np.int32)}
    commit = (np.asarray([[1, 2, 4, 0], [1, 3, 0, 0], [0] * 4], np.int32), np.asarray([3, 2, 0], np.int32),
              np.asarray([8, 5, 0], np.int32), np.asarray([True, True, False]))
    toks = {"ingest": rng.integers(0, cfg.vocab, size=(3, 8)), "tree": rng.integers(0, cfg.vocab, size=(3, 7)),
            "ragged": rng.integers(0, cfg.vocab, size=16)}

    def run(name, d, cache):
        def t(a):
            return torch.as_tensor(np.asarray(a), device=d)

        p = devs[d]
        if name == "ingest":
            return ss.make_pool_decode_step(cfg)(p, cache, t(toks[name]), t(np.int32([8, 5, 0])))[:2]
        if name == "tree":
            return ss.make_pool_tree_step(cfg)(p, cache, t(toks[name]), t(parents), t([True, True, False]))[:2]
        if name == "commit":
            return None, ss.make_pool_commit_step(7)(cache, *(t(a) for a in commit))
        return ss.make_pool_ragged_tree_step(cfg)(p, cache, t(toks[name]), *(t(ragged[k]) for k in (
            "owner", "parent", "depth", "local", "counts")))[:2]

    real_rows = {"ingest": np.s_[:2], "tree": np.s_[:2], "commit": None, "ragged": np.s_[:14]}
    worst = 0.0
    for name, real in real_rows.items():
        logits = {}
        for d in devs:
            lg, caches[d] = run(name, d, caches[d])
            logits[d] = None if lg is None else lg.cpu()
        views = {d: gather_streams(caches[d], range(3))["attn"] for d in devs}
        live = views["cpu"]["pos"] >= 0
        if not torch.equal(views["cuda"]["pos"].cpu(), views["cpu"]["pos"]):
            raise RuntimeError(f"{name}: pos tables differ between the card and the CPU")
        errs = []
        if logits["cpu"] is not None:
            scale = max(1.0, logits["cpu"][real].abs().max().item())
            errs.append((logits["cuda"][real] - logits["cpu"][real]).abs().max().item() / scale)
        for kv in ("k", "v"):
            a, b = views["cuda"][kv].cpu()[:, live], views["cpu"][kv][:, live]
            errs.append((a - b).abs().max().item() / max(1.0, b.abs().max().item()))
        rel = max(errs)
        worst = max(worst, rel)
        log(f"  {name}: max relative |card - cpu| over logits of real rows and KV of admitted lanes = {rel:.3e}")
        if rel > 1e-3:
            raise RuntimeError(f"full-width draft on the card disagrees with the CPU in the {name} pass: {rel}")
    return worst


# ------------------------------------------------------------ phase 5: MoE ---

MOE_ARCH, MOE_TARGET_LAYERS = "qwen3-moe-235b-a22b", 8  # full width; depth cut from 94 to fit one card


def moe_configs():
    """qwen3-moe-235b-a22b at full width with n_layers cut from 94 to 8 (the
    full model is 437.9 GiB in bf16), and make_draft_cfg of the FULL config
    at its own depth (23 layers, d 2048, 32 heads, 2 KV heads, 64 experts
    top-8, d_ff 768)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_draft_cfg

    full = get_config(MOE_ARCH)
    return full.replace(n_layers=MOE_TARGET_LAYERS), make_draft_cfg(full)


def phase_moe(torch):
    log(f"== phase 5: MoE path, full-width {MOE_ARCH} ({MOE_TARGET_LAYERS} of 94 layers) + draft, bf16")
    import gc

    import numpy as np

    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg, dcfg = moe_configs()
    for role, c in (("target", tcfg), ("draft ", dcfg)):
        log(f"{role} {c.name}: L={c.n_layers} d={c.d_model} H={c.n_heads} Hkv={c.n_kv_heads} hd={c.hd} "
            f"E={c.n_experts} top_k={c.top_k} ff={c.d_ff} V={c.vocab} ({c.param_count() / 1e9:.2f} B params, "
            f"{c.param_count() * 2 / 2**30:.1f} GiB bf16)")
    t0 = time.perf_counter()
    tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
    dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    log(f"weights drawn on the card in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    layers = (tcfg.n_layers, dcfg.n_layers)
    rng = np.random.default_rng(5)
    sampling = SamplingParams(1.0, 1.0)
    results = {"target": {"n_layers": tcfg.n_layers, "params": tcfg.param_count()},
               "draft": {"n_layers": dcfg.n_layers, "params": dcfg.param_count()}}

    # single stream: one specinfer (2, 2, 2) request of 32 new tokens
    prompt = rng.integers(0, tcfg.vocab, size=8).tolist()
    SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=9), sampling).generate(
        prompt, max_new=8)  # cuBLAS and allocator warm-up, not measured
    eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=0), sampling)
    outs, wall, launches, be = _run_engine(torch, eng, [prompt], 32, layers)
    c = eng.counters
    log(f"  single stream specinfer (2,2,2): {outs[0]}")
    log(f"  block_efficiency={be:.4f} blocks={c['blocks']} target_calls={c['target_calls']} "
        f"draft_calls={c['draft_calls']} wall={wall:.4f} s tokens/s={32 / wall:.3f} tree_attention "
        f"launches={launches} (= {layers[0]} x {1 + c['target_calls']} + {layers[1]} x {1 + c['draft_calls']})")
    results["single"] = {"block_efficiency": be, "wall_s": wall, "tokens_per_s": 32 / wall, "launches": launches,
                         "steps": c["blocks"]}

    # batched: 8 rows, 12 requests, pipelined then synchronous
    prompts = [rng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(N_REQUESTS)]
    max_new = [16 + (32 * i) // (N_REQUESTS - 1) for i in range(N_REQUESTS)]
    seeds = [200 + i for i in range(N_REQUESTS)]

    def engine(pipeline):
        return BatchedSpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024), sampling,
                                        n_slots=N_SLOTS, paged=True, block_size=64, pipeline=pipeline)

    engine(True).generate_batch(prompts[:2], max_new=8, seeds=seeds[:2])  # warm-up, not measured
    tokens = {}
    for mode, pipeline in (("pipelined", True), ("sync", False)):
        tokens[mode], results[mode] = _serve_batched(torch, engine(pipeline), prompts, max_new, seeds, layers)
        r = results[mode]
        log(f"  {mode}: {r['tokens']} tokens in {r['wall_s']:.4f} s = {r['tokens_per_s']:.3f} tok/s aggregate, "
            f"per-stream median {r['per_stream_tokens_per_s_median']:.3f} tok/s, block_efficiency "
            f"{r['block_efficiency']:.4f}, pad_fraction {r['pad_fraction']:.4f}, blocks_peak {r['blocks_peak']}, "
            f"steps {r['steps']} (padded {r['padded_calls']}, ragged {r['ragged_calls']}), "
            f"ahead {r['pipeline_ahead']} stalls {r['pipeline_stalls']}, launches {r['launches']}")
    if tokens["pipelined"] != tokens["sync"]:
        bad = [i for i, (a, b) in enumerate(zip(tokens["pipelined"], tokens["sync"])) if a != b]
        raise RuntimeError(f"MoE: pipelined tokens differ from synchronous tokens for requests {bad}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  pipelined tokens == sync tokens for all {N_REQUESTS} requests; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB of {total / 2**30:.3f} GiB")
    results["max_memory_allocated"] = peak
    # a short window: the whole script keeps within its time budget
    results["profile"] = _profile_batched(torch, engine(True), prompts[:N_SLOTS], seeds[:N_SLOTS], 2)
    del tp, dp, eng
    gc.collect()
    torch.cuda.empty_cache()
    return results, launches


# ------------------------------------------- phase 6: dynamic delayed expansion ---

NDE_ACTIONS = [(1, 3, 0), (2, 1, 1), (2, 2, 2), (4, 1, 1)]  # the grid of examples/train_selector.py
NDE_FIT_LENGTHS = (16, 256, 512, 896)  # committed tokens of the timed passes, inside the 1024-slot ring
NDE_FIT_TREES = ((1, 1, 0), (2, 2, 2), (4, 2, 3))  # trees of 2, 7 and 15 nodes


def nde_configs():
    """Phases 3-4's pair: full-width granite-8b and its make_draft_cfg draft."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_draft_cfg

    tcfg = get_config("granite-8b")
    return tcfg, make_draft_cfg(tcfg)


class ActionLog:
    """Wraps a selector: records each call's action by the engine's block
    count at the call (the calls of one batched step share it; the next step
    sees a larger one) and sums the Eq. 11 time ``latency`` models for it,
    as examples/train_selector.py prices a run."""

    def __init__(self, selector, latency):
        self.selector, self.latency = selector, latency
        self.by_step: dict[int, list] = {}
        self.modelled_s = 0.0

    def __call__(self, stream, engine):
        a = tuple(self.selector(stream, engine))
        self.by_step.setdefault(engine.counters["blocks"], []).append(a)
        self.modelled_s += self.latency.action_time(len(stream["committed"]), *a)
        return a

    def levels(self):
        """Each step's (trunk steps, branch steps): its batch's deepest L1 and L2."""
        return [(max(a[1] for a in acts), max(a[2] for a in acts)) for _, acts in sorted(self.by_step.items())]

    def histogram(self):
        return dict(sorted(collections.Counter(str(a) for acts in self.by_step.values() for a in acts).items()))

    def mixed_steps(self):
        return sum(len(set(acts)) > 1 for acts in self.by_step.values())


def _delayed_parents(K, L1, L2):
    """Parent array of a (K, L1, L2)-delayed tree in the engine's node order."""
    parent, node = [-1], 0
    for _ in range(L1):
        parent.append(node)
        node = len(parent) - 1
    tips = [node] * K
    for _ in range(L2):
        for k in range(K):
            parent.append(tips[k])
            tips[k] = len(parent) - 1
    return parent


def _walls(torch, fns, rounds=11):
    """Median host time (s) of each of ``fns`` from a synchronised card to a
    synchronised card (what the engine waits for a pass), after two calls
    of each.  The calls go round-robin, one of each a round, so that a slow
    spell of the shared host spreads over every reading."""
    for fn in fns:
        fn()
        fn()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, ts in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
    return [statistics.median(ts) for ts in times]


def fit_latency(torch, eng, smi):
    """Phase 6a: fit LatencyModel (Eq. 11's affine pass times) to the
    engine's own passes on the card: a one-token draft decode after l
    committed tokens, t_q(l + 1) = t_q_base + t_q_per_tok (l + 1), and a
    target tree pass of n + 1 nodes, t = t_p_base + t_p_per_tok (l + 1 + n)
    + t_p_per_tree_tok n, by least squares over the medians of 11 timed
    calls of each."""
    import numpy as np

    from repro_torch.core.delayed import LatencyModel
    from repro_torch.core.trees import tree_ancestor_mask

    rng = np.random.default_rng(6)
    vocab = eng.tc.vocab
    q_cases, p_cases = [], []  # (l + 1, closure), (l + 1, n, closure)
    for length in NDE_FIT_LENGTHS:
        stream = eng.new_stream(rng.integers(0, vocab, size=length + 1).tolist())  # caches hold `length`
        tok = [int(rng.integers(0, vocab))]
        q_cases.append((length + 1, lambda st=stream, t=tok: eng._draft_decode(st["dcache"], t)))
        for K, L1, L2 in NDE_FIT_TREES:
            parent = np.asarray(_delayed_parents(K, L1, L2))
            anc = tree_ancestor_mask(parent)
            toks = rng.integers(0, vocab, size=len(parent))
            p_cases.append((length + 1, len(parent) - 1,
                            lambda st=stream, t=toks, a=anc: eng._target_pass_tree(st["tcache"], t, a)))
    walls = _walls(torch, [c[-1] for c in q_cases + p_cases])
    q_rows = [(l, t) for (l, _), t in zip(q_cases, walls)]
    p_rows = [(l, n, t) for (l, n, _), t in zip(p_cases, walls[len(q_cases):])]
    del q_cases, p_cases
    xq = np.asarray([[1.0, l] for l, _ in q_rows])
    yq = np.asarray([t for _, t in q_rows])
    xp = np.asarray([[1.0, l + n, n] for l, n, _ in p_rows])
    yp = np.asarray([t for _, _, t in p_rows])
    cq = np.linalg.lstsq(xq, yq, rcond=None)[0]
    cp = np.linalg.lstsq(xp, yp, rcond=None)[0]
    lat = LatencyModel(float(cq[0]), float(cq[1]), float(cp[0]), float(cp[1]), float(cp[2]))
    res = np.concatenate([xq @ cq - yq, xp @ cp - yp])
    ys = np.concatenate([yq, yp])
    fit = {"t_q_base_ms": lat.t_q_base * 1e3, "t_q_per_tok_us": lat.t_q_per_tok * 1e6,
           "t_p_base_ms": lat.t_p_base * 1e3, "t_p_per_tok_us": lat.t_p_per_tok * 1e6,
           "t_p_per_tree_tok_ms": lat.t_p_per_tree_tok * 1e3,
           "residual_rms_ms": float(np.sqrt(np.mean(res ** 2))) * 1e3,
           "residual_max_rel": float(np.max(np.abs(res) / ys)),
           "draft_decode_ms": {str(l): t * 1e3 for l, t in q_rows},
           "target_tree_pass_ms": {f"{l}+{n}": t * 1e3 for l, n, t in p_rows}, "nvidia_smi": smi}
    for l, t in q_rows:
        log(f"  draft decode of 1 token after {l - 1:4d} tokens: {t * 1e3:8.3f} ms")
    for l, n, t in p_rows:
        log(f"  target tree pass of {n + 1:2d} nodes after {l - 1:4d} tokens: {t * 1e3:8.3f} ms")
    log(f"  LatencyModel fitted on {smi}: t_q(l) = {fit['t_q_base_ms']:.4f} ms + {fit['t_q_per_tok_us']:.4f} us x l; "
        f"t_p(l) = {fit['t_p_base_ms']:.4f} ms + {fit['t_p_per_tok_us']:.4f} us x l, "
        f"+ {fit['t_p_per_tree_tok_ms']:.4f} ms a tree token; residual rms {fit['residual_rms_ms']:.4f} ms, "
        f"max {100 * fit['residual_max_rel']:.2f} % of a reading")
    if not all(np.isfinite(list(v for v in fit.values() if isinstance(v, float)))):
        raise RuntimeError(f"latency fit is not finite: {fit}")
    return lat, fit


def _peek_check(torch, tcfg, tp, dcfg, dp, prompt, sampling):
    """Phase 6f's second half: one pooled peek (a pool row gathered to a
    dense copy) against the single-stream peek at the same committed prefix;
    the pools must come out bit for bit as they were."""
    import numpy as np

    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SpeculativeEngine

    ecfg = EngineConfig("specinfer", 2, 2, 2, 1024, seed=3)
    beng = BatchedSpeculativeEngine(tcfg, tp, dcfg, dp, ecfg, sampling, n_slots=1, paged=True, block_size=64,
                                    pipeline=False)
    beng.submit(prompt, max_new=16, seed=3)
    beng.step()
    bstream = next(iter(beng.streams.values()))
    single = SpeculativeEngine(tcfg, tp, dcfg, dp, ecfg, sampling)
    sstream = single.new_stream(list(bstream["committed"]))
    before = [t.clone() for pool in (beng.tpool, beng.dpool) for t in pool.cache["attn"].values()]
    ctx = [int(bstream["committed"][0])]
    diffs = {}
    for name, ctx_ in (("target", []), ("target +1", ctx), ("draft", []), ("draft +1", ctx)):
        kind = name.split()[0]
        pooled = getattr(beng, f"peek_{kind}_dist")(bstream, ctx_)
        alone = getattr(single, f"peek_{kind}_dist")(sstream, ctx_)
        for d in (pooled, alone):
            if not (np.isfinite(d).all() and abs(float(d.sum()) - 1.0) < 1e-3):
                raise RuntimeError(f"peek {name}: not a distribution (sum {d.sum()})")
        diffs[name] = float(np.abs(pooled - alone).max())
    after = [t for pool in (beng.tpool, beng.dpool) for t in pool.cache["attn"].values()]
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise RuntimeError("a pooled peek changed the pool")
    log(f"  pooled peek vs single-stream peek after {len(bstream['committed'])} committed tokens, max abs diff: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()) + "; pools unchanged bit for bit")
    return diffs


def phase_nde(torch, smi):
    log("== phase 6: dynamic delayed expansion on full-width granite-8b + draft, bf16")
    import gc

    import numpy as np

    from repro_torch.core.selector import FixedSpace, SelectorConfig
    from repro_torch.kernels.tree_attention import tree_attention
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine
    from repro_torch.serving.nde import AnalyticSelector, NeuralSelector, StaticSelector
    from repro_torch.training.selector_train import best_static_action, collect_traces, train_selector

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg, dcfg = nde_configs()
    tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
    dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    layers = (tcfg.n_layers, dcfg.n_layers)
    sampling = SamplingParams(1.0, 1.0)
    rng = np.random.default_rng(7)
    results = {}

    def single(seed, selector=None, action=(2, 2, 2)):
        return SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", *action, 1024, seed=seed),
                                 sampling, selector=selector)

    single(9).generate(rng.integers(0, tcfg.vocab, size=8).tolist(), max_new=8)  # warm-up, not measured

    log("-- 6a: the latency model, fitted on the card")
    t0 = time.perf_counter()
    lat, results["latency_fit"] = fit_latency(torch, single(9), smi)
    results["latency_fit"]["seconds"] = time.perf_counter() - t0

    log(f"-- 6b: Eq. 3 labels (collect_traces), specinfer, actions {NDE_ACTIONS}, s = 1")
    t0 = time.perf_counter()
    prompts = [rng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(2)]
    parts, label_launches = [], 0
    for i, prompt in enumerate(prompts):
        eng = single(20 + i)
        torch.cuda.synchronize()
        tree_attention.launches = 0
        part = collect_traces(eng, [prompt], NDE_ACTIONS, lat, tokens_per_prompt=20, stride=4, s=1, seed=i)
        torch.cuda.synchronize()
        c = eng.counters
        want = layers[0] * (1 + c["target_calls"]) + layers[1] * (1 + c["draft_calls"])
        if tree_attention.launches != want:
            raise RuntimeError(f"collect_traces: tree_attention launched {tree_attention.launches} times, "
                               f"expected {want} (masked passes, peeks included, x layers)")
        label_launches += want
        if part["eff"].shape[0] < 3:
            raise RuntimeError(f"prompt {i}: {part['eff'].shape[0]} roots labelled, expected at least 3")
        parts.append(part)
    traces = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    for k, v in traces.items():
        if not np.isfinite(v).all():
            raise RuntimeError(f"traces[{k!r}] holds non-finite values")
    if not ((traces["eff"] >= 1.0) & (traces["eff"] <= 1 + np.asarray([a[1] + a[2] for a in NDE_ACTIONS]))).all():
        raise RuntimeError(f"an Eq. 3 label lies outside [1, 1 + L1 + L2]: {traces['eff']}")
    log(f"  {traces['eff'].shape[0]} roots ({', '.join(str(p['eff'].shape[0]) for p in parts)} a prompt) x "
        f"{len(NDE_ACTIONS)} actions in {time.perf_counter() - t0:.2f} s; tree_attention launches {label_launches}")
    log("  eff (E[tau + 1] by Eq. 3) | time (ms, Eq. 11) per action " + " ".join(map(str, NDE_ACTIONS)))
    for r in range(traces["eff"].shape[0]):
        log("    root %2d: " % r + " ".join(f"{e:6.3f}" for e in traces["eff"][r]) + "  | "
            + " ".join(f"{1e3 * t:8.3f}" for t in traces["time"][r]))
    base = best_static_action(traces)
    results["traces"] = {"roots": int(traces["eff"].shape[0]), "eff": traces["eff"].tolist(),
                         "time_ms": (1e3 * traces["time"]).tolist(), "best_static_action": list(NDE_ACTIONS[base]),
                         "launches": label_launches, "seconds": time.perf_counter() - t0}

    log("-- 6c: selector training (train_selector, Eq. 12) on the card")
    t0 = time.perf_counter()
    scfg = SelectorConfig(hidden_p=tcfg.d_model, hidden_q=dcfg.d_model, space=FixedSpace(NDE_ACTIONS))
    params, losses = train_selector(traces, scfg, steps=150, batch=16, lam=0.3, device="cuda")
    torch.cuda.synchronize()
    devices = {str(t.device) for layer in params.values() for t in layer.values()}
    if not (np.isfinite(losses[0]) and np.isfinite(losses[-1])) or devices != {"cuda:0"}:
        raise RuntimeError(f"training: loss {losses[0]} -> {losses[-1]}, parameters on {devices}")
    log(f"  hidden_p {scfg.hidden_p}, hidden_q {scfg.hidden_q}, dropout {scfg.dropout}, 150 steps of 16: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in {time.perf_counter() - t0:.2f} s, parameters on {devices}")
    results["training"] = {"first_loss": losses[0], "last_loss": losses[-1], "steps": len(losses),
                           "seconds": time.perf_counter() - t0}

    log(f"-- 6d: single stream, best static action {NDE_ACTIONS[base]} against NeuralSelector, 32 tokens")
    prompt = rng.integers(0, tcfg.vocab, size=8).tolist()
    single_launches = label_launches
    results["single"] = {}
    for name, sel in (("static", StaticSelector(*NDE_ACTIONS[base])),
                      ("nde", NeuralSelector(params, scfg, lat, sampling))):
        alog = ActionLog(sel, lat)
        eng = single(1, alog)
        outs, wall, launches, be = _run_engine(torch, eng, [prompt], 32, layers, alog)
        single_launches += launches
        c = eng.counters
        produced = c["accepted"] + c["blocks"]
        r = {"tokens_per_s": 32 / wall, "block_efficiency": be, "modelled_tokens_per_s": produced / alog.modelled_s,
             "actions": alog.histogram(), "steps": c["blocks"], "launches": launches, "wall_s": wall}
        results["single"][name] = r
        log(f"  {name:6s}: {r['tokens_per_s']:.3f} tok/s, block_efficiency {be:.4f}, modelled "
            f"{r['modelled_tokens_per_s']:.3f} tok/s, {c['blocks']} steps, actions {r['actions']}, "
            f"tree_attention launches {launches}; {outs[0]}")

    log(f"-- 6e: continuous batching under NeuralSelector, {N_SLOTS} rows, {N_REQUESTS} requests, pipelined")
    prng = np.random.default_rng(4)  # phase 4's traffic
    bprompts = [prng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(N_REQUESTS)]
    max_new = [16 + (32 * i) // (N_REQUESTS - 1) for i in range(N_REQUESTS)]
    seeds = [100 + i for i in range(N_REQUESTS)]

    def mixed(stream, engine):
        """A content-keyed selector of mixed actions: every step mixes them."""
        return NDE_ACTIONS[(stream["rid"] + len(stream["committed"])) % len(NDE_ACTIONS)]

    batched_runs = []
    results["batched"] = {}
    for name, sel in (("nde", NeuralSelector(params, scfg, lat, sampling)), ("mixed", mixed)):
        alog = ActionLog(sel, lat)
        eng = BatchedSpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024), sampling,
                                       selector=alog, n_slots=N_SLOTS, paged=True, block_size=64, pipeline=True)
        _, r = _serve_batched(torch, eng, bprompts, max_new, seeds, layers, actions=alog, need_both=False)
        r.update(actions=alog.histogram(), mixed_steps=alog.mixed_steps())
        batched_runs.append(r["launches"])
        results["batched"][name] = r
        log(f"  {name:5s}: {r['tokens']} tokens in {r['wall_s']:.4f} s = {r['tokens_per_s']:.3f} tok/s aggregate, "
            f"per-stream median {r['per_stream_tokens_per_s_median']:.3f} tok/s, block_efficiency "
            f"{r['block_efficiency']:.4f}, actions {r['actions']}, steps {r['steps']} of which "
            f"{r['mixed_steps']} mixed actions (padded {r['padded_calls']}, ragged {r['ragged_calls']}), "
            f"pad_fraction {r['pad_fraction']:.4f}, ahead {r['pipeline_ahead']} stalls {r['pipeline_stalls']}, "
            f"launches {r['launches']}")
    if results["batched"]["mixed"]["mixed_steps"] < 1:
        raise RuntimeError("the content-keyed selector never mixed actions within a step")
    if not sum(r["ragged_paged_tree_attention"] for r in batched_runs):
        raise RuntimeError("no ragged tree pass ran under mixed actions")

    log("-- 6f: AnalyticSelector, actions (1,1,0) and (2,1,1), one request of 8 tokens")
    alog = ActionLog(AnalyticSelector([(1, 1, 0), (2, 1, 1)], lat, "specinfer", s=1, seed=0), lat)
    eng = single(2, alog)
    outs, wall, launches, be = _run_engine(torch, eng, [prompt], 8, layers, alog)
    single_launches += launches
    results["analytic"] = {"tokens_per_s": 8 / wall, "block_efficiency": be, "actions": alog.histogram(),
                           "launches": launches, "steps": eng.counters["blocks"]}
    log(f"  {8 / wall:.3f} tok/s (peeks included), block_efficiency {be:.4f}, actions {alog.histogram()}, "
        f"target calls {eng.counters['target_calls']}, draft calls {eng.counters['draft_calls']} (peeks included), "
        f"tree_attention launches {launches}; {outs[0]}")
    results["peek_max_abs_diff"] = _peek_check(torch, tcfg, tp, dcfg, dp, prompt, sampling)
    results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    results["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 6 took {results['seconds']:.1f} s; max_memory_allocated "
        f"{results['max_memory_allocated'] / 2**30:.3f} GiB")
    del tp, dp, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return results, single_launches, batched_runs

# ---------------------------------------------- phase 7: the recurrent families ---

RECURRENT_ARCHES = ("mamba2-2.7b", "recurrentgemma-2b")
# the targets' depth cut to keep the script near half its time limit (the drafts are the full
# configs'): mamba2-2.7b's 64 layers to 32 once phase 12 was added (PR 22), then to 16, and
# recurrentgemma-2b's 26 to 14 (4 groups of (rec, rec, local-attn) and the tail of 2), once
# phase 8g was added (PR 24; 8b serves the same cut pair)
RECURRENT_TARGET_LAYERS = {"mamba2-2.7b": 16, "recurrentgemma-2b": 14}
LONG_PROMPT, LONG_RING = 2600, 4096  # 7c: a prompt past the 2048-slot window, on a ring that holds it


def _attn_layers(cfg):
    """Layers with masked attention: every layer of an attention stack, the
    local-attention layer of each hybrid group, none in an SSM."""
    if cfg.arch_type == "ssm":
        return 0
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def phase_recurrent_reference(torch, cfg, seed, title):
    """A full-width recurrent draft ``cfg`` in float32: the card (kernels)
    against the CPU (plain versions), same weights: a 7-token prefill, a
    one-token decode, a 3-token trunk decode from the state (the chunked
    SSD branch), and a K = 2 fork of the post-trunk cache decoding 2
    tokens a branch.  Logits and every recurrent state leaf are held to
    1e-3 of their scale."""
    log(f"== {title} on the card against the CPU, float32")
    import numpy as np

    from repro_torch.models.cache import fork_streams
    from repro_torch.models.transformer import forward, init_cache, init_params

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    devs = {"cuda": params, "cpu": to_cpu(params)}
    rng = np.random.default_rng(seed)
    passes = [("prefill", rng.integers(0, cfg.vocab, size=(1, 7)), False),
              ("decode", rng.integers(0, cfg.vocab, size=(1, 1)), False),
              ("trunk", rng.integers(0, cfg.vocab, size=(1, 3)), False),
              ("forked branch", rng.integers(0, cfg.vocab, size=(2, 2)), True)]
    caches = {d: init_cache(cfg, 1, 1024, d) for d in devs}
    worst = 0.0
    for name, toks, fork in passes:
        logits, new = {}, {}
        for d, p in devs.items():
            lg, new[d], _ = forward(p, cfg, torch.as_tensor(toks, device=d), mode="full" if name == "prefill"
                                    else "decode", cache=fork_streams(caches[d], 2) if fork else caches[d])
            logits[d] = lg.cpu()
        errs = [(logits["cuda"] - logits["cpu"]).abs().max().item() / max(1.0, logits["cpu"].abs().max().item())]
        for leaf in ("state", "rec_state", "tail_state"):
            if leaf in new["cpu"]:
                a, b = new["cuda"][leaf].cpu(), new["cpu"][leaf]
                errs.append((a - b).abs().max().item() / max(1.0, b.abs().max().item()))
        rel = max(errs)
        worst = max(worst, rel)
        log(f"  {name}: max relative |card - cpu| over logits and recurrent state = {rel:.3e}")
        if not torch.isfinite(logits["cuda"]).all() or rel > 1e-3:
            raise RuntimeError(f"{cfg.name} on the card disagrees with the CPU in the {name} pass: {rel}")
        if not fork:
            caches = new
    del params, devs, caches
    torch.cuda.empty_cache()
    return worst


def phase_recurrent(torch, then=None):
    """7a-7c: each recurrent pair at full width through both engines, launch
    counts exact; the long-context hybrid request.  ``then(tcfg, tp, dcfg,
    dp, ctx)`` runs on the hybrid pair and its traffic before they are
    freed."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine

    t_phase = time.perf_counter()
    sampling = SamplingParams(1.0, 1.0)
    results, single_launches, batched_runs = {}, 0, []
    for i, arch in enumerate(RECURRENT_ARCHES):
        t_arch = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full = get_config(arch)
        tcfg = full.replace(n_layers=RECURRENT_TARGET_LAYERS.get(arch, full.n_layers))
        dcfg = make_draft_cfg(full)
        cut = "" if tcfg.n_layers == full.n_layers else \
            f", the target cut from {full.n_layers} to {tcfg.n_layers} layers"
        log(f"== phase 7{'ab'[i]}: {arch} + draft at full width{cut}, bf16, replay strategy")
        for role, c in (("target", tcfg), ("draft ", dcfg)):
            log(f"{role} {c.name}: L={c.n_layers} d={c.d_model} " + (
                f"d_inner={c.d_inner} heads={c.ssm_heads}x{c.ssm_headdim} state={c.ssm_state} "
                f"chunk={c.ssm_chunk}" if c.arch_type == "ssm" else
                f"lru={c.lru_d} H={c.n_heads} Hkv={c.n_kv_heads} hd={c.hd} window={c.local_window} ff={c.d_ff}")
                + f" V={c.vocab} ({c.param_count() / 1e9:.2f} B params)")
        tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
        dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        layers = (_attn_layers(tcfg), _attn_layers(dcfg))
        rng = np.random.default_rng(7 + i)
        res = {"target": {"n_layers": tcfg.n_layers, "params": tcfg.param_count(), "attn_layers": layers[0]},
               "draft": {"n_layers": dcfg.n_layers, "params": dcfg.param_count(), "attn_layers": layers[1]}}

        prompt = rng.integers(0, tcfg.vocab, size=8).tolist()
        prompts = [rng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(N_REQUESTS)]
        max_new = [16 + (32 * j) // (N_REQUESTS - 1) for j in range(N_REQUESTS)]
        seeds = [300 + j for j in range(N_REQUESTS)]

        def engine(pipeline):
            return BatchedSpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024), sampling,
                                            n_slots=N_SLOTS, paged=True, block_size=64, pipeline=pipeline)

        # one profiled step of a full pool, device only; it also warms the allocator and
        # cuBLAS for the pair's shapes, so no run below is a warm-up
        res["profile"] = _profile_batched(torch, engine(True), prompts[:N_SLOTS], seeds[:N_SLOTS], 1, host_ops=False)
        res["profile"]["launches_per_step"] = res["profile"]["launches"] / res["profile"]["steps"]
        eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=0), sampling)
        outs, wall, launches, be = _run_engine(torch, eng, [prompt], 32, layers)
        single_launches += launches
        c = eng.counters
        res["single"] = {"block_efficiency": be, "wall_s": wall, "tokens_per_s": 32 / wall, "launches": launches,
                         "steps": c["blocks"], "target_calls": c["target_calls"], "draft_calls": c["draft_calls"]}
        log(f"  single stream specinfer (2,2,2): {32 / wall:.3f} tok/s, block_efficiency {be:.4f}, "
            f"{c['blocks']} steps, target calls {c['target_calls']} (+ {c['blocks']} commits), draft calls "
            f"{c['draft_calls']}, tree_attention launches {launches} (= {layers[0]} x (1 + {c['target_calls']} "
            f"+ {c['blocks']}) + {layers[1]} x (1 + {c['draft_calls']})); {outs[0]}")

        # pipelined only: the synchronous runs (~42 s of the script) were cut in PR 24 for phase 8g
        tokens = {}
        tokens["pipelined"], r = _serve_batched(torch, engine(True), prompts, max_new, seeds, layers, need_both=False)
        res["pipelined"] = r
        batched_runs.append(r["launches"])
        log(f"  pipelined: {r['tokens']} tokens in {r['wall_s']:.4f} s = {r['tokens_per_s']:.3f} tok/s aggregate, "
            f"per-stream median {r['per_stream_tokens_per_s_median']:.3f} tok/s, block_efficiency "
            f"{r['block_efficiency']:.4f}, {r['steps']} steps, ahead {r['pipeline_ahead']} stalls "
            f"{r['pipeline_stalls']}, launches {r['launches']}")
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  max_memory_allocated {res['max_memory_allocated'] / 2**30:.3f} GiB")
        res["seconds"] = time.perf_counter() - t_arch
        parts = {"profile": res["profile"]["seconds"], "single": res["single"]["wall_s"],
                 "pipelined": res["pipelined"]["wall_s"]}
        log(f"  phase 7{'ab'[i]} took {res['seconds']:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
            + f", the rest (weights, engines, admissions) {res['seconds'] - sum(parts.values()):.1f} s")

        if tcfg.arch_type == "hybrid":
            log(f"== phase 7c: one {arch} request of {LONG_PROMPT} prompt tokens on a {LONG_RING}-slot ring, "
                f"past the {tcfg.local_window}-slot window")
            long_prompt = rng.integers(0, tcfg.vocab, size=LONG_PROMPT).tolist()
            eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, LONG_RING, seed=5),
                                    sampling)
            outs, wall, launches, be = _run_engine(torch, eng, [long_prompt], 16, layers)
            single_launches += launches
            res["long_context"] = {"prompt": LONG_PROMPT, "ring": LONG_RING, "window": tcfg.local_window,
                                   "wall_s": wall, "block_efficiency": be, "launches": launches,
                                   "steps": eng.counters["blocks"]}
            res["long_context"]["seconds"] = time.perf_counter() - t_arch - res["seconds"]
            log(f"  served 16 tokens after the prefill in {wall:.4f} s (prefill included), block_efficiency "
                f"{be:.4f}, tree_attention launches {launches}; {outs[0]}")
            if then is not None:
                then(tcfg, tp, dcfg, dp, {"prompts": prompts, "max_new": max_new, "seeds": seeds, "layers": layers,
                                          "tokens": tokens["pipelined"], "results": res})
        results[arch] = res
        del tp, dp, eng
        gc.collect()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    drafts = {arch: make_draft_cfg(get_config(arch)).replace(dtype="float32") for arch in RECURRENT_ARCHES}
    results["draft_card_vs_cpu_rel_err"] = {
        arch: phase_recurrent_reference(torch, cfg, 11, f"phase 7d: the full-width {arch} draft")
        for arch, cfg in drafts.items()}
    log(f"  phase 7d took {time.perf_counter() - t_ref:.1f} s")
    results["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 7 took {results['seconds']:.1f} s")
    return results, single_launches, batched_runs


# ------------------ phase 8: the sharded engine, and verification on the card ---

SHARDS = 2
LAW_DRAWS, WALK_DRAWS = 20000, 5000
# tests/test_torch_otlp_device.py holds each law to atol 0.04 at 4000 draws (about 5 standard errors);
# at LAW_DRAWS the same margin in standard errors is 0.04 * sqrt(4000 / LAW_DRAWS).  The walk's
# tolerance is the CPU test's at its own draw count.
LAW_ATOL, WALK_WORST = 0.04 * (4000 / LAW_DRAWS) ** 0.5, 0.05


def _sharded_engine(tcfg, tp, dcfg, dp, pipeline):
    from repro_torch.serving.batch_engine import ShardedBatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SamplingParams

    return ShardedBatchedSpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024),
                                           SamplingParams(1.0, 1.0), n_slots=N_SLOTS, data_shards=SHARDS,
                                           paged=True, block_size=64, pipeline=pipeline)


def _log_sharded(mode, r, extra=""):
    log(f"  {mode}: {r['tokens']} tokens in {r['wall_s']:.4f} s = {r['tokens_per_s']:.3f} tok/s aggregate, "
        f"per-stream median {r['per_stream_tokens_per_s_median']:.3f} tok/s, block_efficiency "
        f"{r['block_efficiency']:.4f}, requests per shard {r['requests_per_shard']}, blocks peak per shard "
        f"{r['blocks_peak_per_shard']}, commits {r['commit_calls']} ({r['grouped_commits']} grouped), "
        f"steps {r['steps']} (padded {r['padded_calls']}, ragged {r['ragged_calls']}), launches {r['launches']}"
        + extra)


def phase_sharded_tree(torch, tcfg, tp, dcfg, dp, ctx):
    """8a: phase 4's models and traffic through the sharded engine (8 rows in
    2 shards of 4), pipelined then synchronous: launch counts exact,
    pipelined == sync tokens, the grouped commit fired, and no more commit
    calls than phase 4's + one a shard."""
    log(f"== phase 8a: phase 4's traffic through ShardedBatchedSpeculativeEngine({N_SLOTS} rows, {SHARDS} shards), "
        f"full-width granite-8b + draft, bf16, tree strategy")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    results, tokens = {}, {}
    for mode, pipeline in (("pipelined", True), ("sync", False)):
        tokens[mode], r = _serve_batched(torch, _sharded_engine(tcfg, tp, dcfg, dp, pipeline), ctx["prompts"],
                                         ctx["max_new"], ctx["seeds"], ctx["layers"], need_both=False)
        results[mode] = r
        limit = ctx["results"][mode]["commit_calls"] + SHARDS
        _log_sharded(mode, r, f"; phase 4 unsharded: {ctx['results'][mode]['tokens_per_s']:.3f} tok/s, "
                              f"{ctx['results'][mode]['commit_calls']} commits")
        if not r["grouped_commits"]:
            raise RuntimeError(f"8a {mode}: the grouped commit never fired")
        if r["commit_calls"] > limit:
            raise RuntimeError(f"8a {mode}: {r['commit_calls']} commit calls, more than phase 4's + {SHARDS} = {limit}")
        r["matches_unsharded"] = sum(a == b for a, b in zip(tokens[mode], ctx["tokens"][mode]))
    if tokens["pipelined"] != tokens["sync"]:
        bad = [i for i, (a, b) in enumerate(zip(tokens["pipelined"], tokens["sync"])) if a != b]
        raise RuntimeError(f"8a: pipelined tokens differ from synchronous tokens for requests {bad}")
    results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    results["pipelined_tokens"] = tokens["pipelined"]  # phase 8f's reference
    results["seconds"] = time.perf_counter() - t_phase
    log(f"  pipelined tokens == sync tokens for all {N_REQUESTS} requests; streams equal to phase 4's unsharded "
        f"tokens: {results['sync']['matches_unsharded']} of {N_REQUESTS} (reported, not claimed: a shard's batch is "
        f"{N_SLOTS // SHARDS} rows, not {N_SLOTS}); max_memory_allocated "
        f"{results['max_memory_allocated'] / 2**30:.3f} GiB; phase 8a took {results['seconds']:.1f} s")
    return results


def phase_sharded_replay(torch, tcfg, tp, dcfg, dp, ctx):
    """8b: phase 7b's recurrentgemma-2b pair and traffic through the sharded
    engine, pipelined: launch counts exact; tokens against 7b's reported."""
    log(f"== phase 8b: phase 7b's traffic through ShardedBatchedSpeculativeEngine({N_SLOTS} rows, {SHARDS} shards), "
        f"full-width {tcfg.name} + draft, bf16, replay strategy, pipelined")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tokens, r = _serve_batched(torch, _sharded_engine(tcfg, tp, dcfg, dp, True), ctx["prompts"], ctx["max_new"],
                               ctx["seeds"], ctx["layers"], need_both=False)
    r["matches_unsharded"] = sum(a == b for a, b in zip(tokens, ctx["tokens"]))
    r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    _log_sharded("pipelined", r, f"; phase 7b unsharded: {ctx['results']['pipelined']['tokens_per_s']:.3f} tok/s")
    r["seconds"] = time.perf_counter() - t_phase
    log(f"  streams equal to phase 7b's unsharded tokens: {r['matches_unsharded']} of {N_REQUESTS} (reported); "
        f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.3f} GiB; phase 8b took {r['seconds']:.1f} s")
    return r


# phase 8f: the launcher's --distributed path (launch/serve.py) with phase 8a's engine settings
RANK_SHARD_ARGS = ["--arch", "granite-8b", "--distributed", "--device", "cuda", "--streams", str(N_SLOTS),
                   "--data-shards", str(SHARDS), "--verifier", "specinfer", "--K", "2", "--L1", "2", "--L2", "2",
                   "--block-size", "64", "--seed", "0"]
RANK_TIMEOUT_S = 400


def _shard_rank(rank, n, init_file, traffic, out):
    """One gloo rank of phase 8f (spawned): serve ``traffic`` ([(prompt,
    max_new, seed)]) through launch/serve.py's ``serve_distributed``, its
    shard on cuda:(rank % cards), every kernel's launch count set to 0
    just before and read just after, every ``all_gather_object`` counted."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
                                timeout=timedelta(seconds=RANK_TIMEOUT_S))
        try:
            from repro_torch.launch import serve

            gathers, gather_object = [0], dist.all_gather_object

            def counted(*a, **kw):
                gathers[0] += 1
                return gather_object(*a, **kw)

            dist.all_gather_object = counted
            torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 sets them in the parent
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.set_device(rank % torch.cuda.device_count())
            torch.cuda.reset_peak_memory_stats()
            counters = _launch_counters()
            for fn in counters.values():
                fn.launches = 0
            res = serve.serve_distributed(serve.build_parser().parse_args(RANK_SHARD_ARGS), requests=traffic)
            eng = res["engine"]
            payload = {"rank": rank, "device": str(eng.local.device), "outs": res["outs"], "routing": res["routing"],
                       "wall_s": res["wall_s"], "launches": {k: fn.launches for k, fn in counters.items()},
                       "exchanges": dict(eng.exchanges), "gathers": gathers[0], "counters": eng.counters,
                       "local_counters": dict(eng.local.counters),
                       "max_memory_allocated": torch.cuda.max_memory_allocated()}
        finally:
            dist.destroy_process_group()
        out.put((rank, True, payload))
    except BaseException:  # reported to the parent, which fails the phase
        out.put((rank, False, traceback.format_exc()))


def phase_rank_shards(torch, a, ctx):
    """8f: phase 8a's configuration and traffic through the launcher's
    ``--distributed`` path, one shard a rank: SHARDS gloo rank processes,
    on one card (two ranks share it) or a card each.  Tokens, reasons and
    routing equal 8a's pipelined run, 12 of 12; each kernel's launches
    summed over the ranks equal 8a's; the ranks exchange once a step (8a's
    steps) and make no other collective.  A rank that fails or hangs
    fails the phase.  Reported: each rank's peak and wall, the aggregate
    tok/s, beside 8a's."""
    import gc
    import queue
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    log(f"== phase 8f: phase 8a's traffic through launch/serve.py --distributed: ShardedBatchedSpeculativeEngine "
        f"with one shard a rank, {SHARDS} gloo ranks on {min(cards, SHARDS)} card(s), full-width granite-8b + "
        "draft drawn on each rank from the launcher's seed (phase 4's), bf16, pipelined")
    gc.collect()
    torch.cuda.empty_cache()
    traffic = list(zip(ctx["prompts"], ctx["max_new"], ctx["seeds"]))
    ctx_mp = mp.get_context("spawn")
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = ctx_mp.Queue()
        procs = [ctx_mp.Process(target=_shard_rank, args=(r, SHARDS, f"{tmp}/init", traffic, out))
                 for r in range(SHARDS)]
        for p in procs:
            p.start()
        try:
            for _ in range(SHARDS):
                rank, ok, payload = out.get(timeout=RANK_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f"8f: rank {rank} failed:\n{payload}")
                got[rank] = payload
        except queue.Empty:
            raise RuntimeError(f"8f: {SHARDS - len(got)} of {SHARDS} ranks did not finish within "
                               f"{RANK_TIMEOUT_S} s") from None
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"8f: rank exit codes {[p.exitcode for p in procs]}")
    ranks = [got[r] for r in range(SHARDS)]
    r0 = ranks[0]
    want = a["pipelined_tokens"]
    match = sum(o["tokens"] == w and o["reason"] == "length" for o, w in zip(r0["outs"], want))
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    steps = a["pipelined"]["engine_steps"]
    wall = max(r["wall_s"] for r in ranks)
    n_tokens = sum(len(o["tokens"]) for o in r0["outs"])
    res = {"ranks": SHARDS, "cards": min(cards, SHARDS), "devices": [r["device"] for r in ranks],
           "matches_8a": match, "routing": r0["routing"], "launches": launches,
           "phase8a_launches": a["pipelined"]["launches"], "exchanges": r0["exchanges"],
           "gathers": [r["gathers"] for r in ranks], "phase8a_engine_steps": steps,
           "wall_s": [r["wall_s"] for r in ranks], "tokens": n_tokens, "tokens_per_s": n_tokens / wall,
           "phase8a_wall_s": a["pipelined"]["wall_s"], "phase8a_tokens_per_s": a["pipelined"]["tokens_per_s"],
           "max_memory_allocated": [r["max_memory_allocated"] for r in ranks],
           "commit_calls": [r["local_counters"]["commit_calls"] for r in ranks],
           "counters": r0["counters"]}
    log(f"  ranks on {res['devices']}: {match} of {N_REQUESTS} requests equal phase 8a's pipelined tokens and "
        f"reasons; routing {'equal to' if r0['routing'] == a['pipelined']['routing'] else 'differs from'} 8a's "
        f"{a['pipelined']['routing']}; exchanges {r0['exchanges']} (8a's steps {steps}), all_gather_object calls "
        f"a rank {res['gathers']}; commits a rank {res['commit_calls']}")
    log(f"  launches summed over the ranks {launches} (8a: {a['pipelined']['launches']})")
    log(f"  wall a rank {', '.join(f'{w:.4f}' for w in res['wall_s'])} s, {n_tokens} tokens = "
        f"{res['tokens_per_s']:.3f} tok/s aggregate (8a pipelined: {a['pipelined']['wall_s']:.4f} s, "
        f"{a['pipelined']['tokens_per_s']:.3f} tok/s; {'two ranks share one card: not a speed across cards' if cards < SHARDS else 'a card a rank'}); "
        f"max_memory_allocated a rank " + ", ".join(f"{m / 2**30:.3f} GiB" for m in res["max_memory_allocated"]))
    for i, (o, w) in enumerate(zip(r0["outs"], want)):
        if o["tokens"] != w or o["reason"] != "length":
            j = _first_divergence(o["tokens"], w)
            raise RuntimeError(f"8f: request {i} ({o['reason']}) differs from phase 8a's pipelined tokens"
                               + (f" first at token {j}" if j is not None else f" in length: {len(o['tokens'])} "
                                                                                f"vs {len(w)}"))
    if any(r["outs"] != r0["outs"] or r["routing"] != r0["routing"] for r in ranks[1:]):
        raise RuntimeError("8f: the ranks returned different results")
    if r0["routing"] != a["pipelined"]["routing"]:
        raise RuntimeError(f"8f: routing {r0['routing']} is not phase 8a's {a['pipelined']['routing']}")
    if launches != a["pipelined"]["launches"]:
        raise RuntimeError(f"8f: launches summed over the ranks {launches} are not phase 8a's "
                           f"{a['pipelined']['launches']}")
    if r0["exchanges"] != {"step": steps, "submit": 0, "pipeline": 0} or any(g != steps for g in res["gathers"]):
        raise RuntimeError(f"8f: exchanges {r0['exchanges']} and all_gather_object calls {res['gathers']} for "
                           f"{steps} steps: expected one a step and no other")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 8f took {res['seconds']:.1f} s")
    return res


# phase 8g: one pool over a data mesh of 2 gloo ranks (BatchedSpeculativeEngine(..., mesh=make_data_mesh(2)))
MESH_RANKS = 2


def _pool_mesh_rank(rank, n, init_file, traffic, out):
    """One gloo rank of phase 8g (spawned): phase 4's engine settings over a
    ``make_data_mesh(n)`` of the ranks, on cuda:(rank % cards), first on
    full-width granite-8b + draft in bf16 (phase 4's seeds), then on 8e's
    float32 cut; each run serves ``traffic`` ([(prompt, max_new, seed)])
    with every kernel's launch count set to 0 just before and read just
    after, every ``all_gather_object`` counted and timed (the wait for the
    other rank included), every boundary that admitted counted."""
    import gc
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
                                timeout=timedelta(seconds=RANK_TIMEOUT_S))
        try:
            from repro_torch.configs import get_config
            from repro_torch.launch.mesh import make_data_mesh
            from repro_torch.launch.serve import make_draft_cfg
            from repro_torch.models.transformer import init_params
            from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
            from repro_torch.serving.engine import EngineConfig, SamplingParams

            gathers, gather_object = [0, 0.0], dist.all_gather_object

            def counted(*a, **kw):
                t = time.perf_counter()
                gathers[0] += 1
                try:
                    return gather_object(*a, **kw)
                finally:
                    gathers[1] += time.perf_counter() - t

            dist.all_gather_object = counted
            torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 sets them in the parent
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.set_device(rank % torch.cuda.device_count())
            mesh = make_data_mesh(n, device_type="cpu")  # gloo: two ranks may share a card
            counters = _launch_counters()
            full = get_config("granite-8b")
            pairs = {"a": (full, make_draft_cfg(full)),
                     "b": (full.replace(n_layers=F32_TARGET_LAYERS, dtype="float32"),
                           make_draft_cfg(full).replace(n_layers=F32_DRAFT_LAYERS, dtype="float32"))}
            payload = {"rank": rank}
            for part, (tcfg, dcfg) in pairs.items():
                torch.cuda.reset_peak_memory_stats()
                tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
                dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
                eng = BatchedSpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024),
                                               SamplingParams(1.0, 1.0), n_slots=N_SLOTS, paged=True,
                                               block_size=64, pipeline=True, mesh=mesh)
                admitting, admit = [0], eng._admit

                def counted_admit():
                    before = len(eng.streams)
                    admit()
                    admitting[0] += len(eng.streams) > before

                eng._admit = counted_admit
                torch.cuda.synchronize()
                g0, s0 = gathers
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                rids = [eng.submit(p, max_new=m, seed=sd) for p, m, sd in traffic]
                steps = 0
                while eng.queue or eng.streams:
                    eng.step()
                    steps += 1
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                payload[part] = {
                    "outs": [eng.finished[r] for r in rids], "wall_s": wall, "steps": steps,
                    "launches": {k: fn.launches for k, fn in counters.items()}, "exchanges": dict(eng.exchanges),
                    "idle_passes": dict(eng.idle_passes), "gathers": gathers[0] - g0, "gather_s": gathers[1] - s0,
                    "admitting": admitting[0],
                    "counters": dict(eng.counters), "rows": [eng.tpool.lo, eng.tpool.hi],
                    "device": str(eng.device), "layers": (tcfg.n_layers, dcfg.n_layers),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
                del eng, tp, dp, admit
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, payload))
    except BaseException:  # reported to the parent, which fails the phase
        out.put((rank, False, traceback.format_exc()))


def _mesh_checks(r, n_requests, what):
    """One rank's run of phase 8g against the design: its exchanges, and
    each kernel's launches equal the single-process engine's count for the
    same passes (``_serve_batched``'s, from the same host counters) less
    the passes the rank held no row of.  Returns the expected launches."""
    c, ex, idle = r["counters"], r["exchanges"], r["idle_passes"]
    n_tgt, n_drf = r["layers"]
    steps = c["target_calls"]
    want_ex = {"admit": r["admitting"], "draft": c["draft_calls"], "target": c["commit_calls"], "commit": 0,
               "peek": 0, "failure": 0}
    if ex != want_ex or r["gathers"] != sum(ex.values()) or c["commit_calls"] != steps:
        raise RuntimeError(f"8g {what}, rank {r['rank']}: exchanges {ex} and all_gather_object calls "
                           f"{r['gathers']} for {steps} steps ({c['commit_calls']} committed): expected {want_ex} "
                           f"and no other collective")
    if c["draft_calls"] != steps * (1 + 2 + 2):
        raise RuntimeError(f"8g {what}: {c['draft_calls']} draft calls for {steps} steps of (2, 2, 2)")
    want = {"tree_attention": (n_requests - idle["prefill"]) * (n_tgt + n_drf) + n_drf * 2 * steps,
            "paged_tree_attention": n_drf * (steps + 2 * steps) + n_tgt * c["padded_calls"],
            "ragged_paged_tree_attention": n_tgt * (c["ragged_calls"] - idle["ragged"]),
            "commit_kv": c["commit_calls"], **{name: 0 for name in NO_ENGINE_PATH}}
    if r["launches"] != want:
        raise RuntimeError(f"8g {what}, rank {r['rank']}: launches {r['launches']}, expected {want} (the "
                           f"single-process engine's passes x layers, less the passes idle here: {idle})")
    return want


def phase_data_mesh(torch, ctx, phase4, f32_tokens):
    """8g: one pool over a data mesh, 2 gloo rank processes on one card (or
    a card each): phase 4's models and traffic in bf16 (a), then 8e's
    float32 cut (b), through BatchedSpeculativeEngine(...,
    mesh=make_data_mesh(2)).  Both ranks return the same tokens and
    reasons; exchanges and launches as the design gives them
    (``_mesh_checks``); (b)'s tokens equal 8e's single-process engine's,
    12 of 12.  Reported: (a)'s matches against phase 4, each rank's peak
    and wall, the aggregate tok/s.  A rank that fails or hangs fails the
    phase."""
    import gc
    import queue
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    log(f"== phase 8g: one pool over a data mesh: BatchedSpeculativeEngine(..., mesh=make_data_mesh({MESH_RANKS})), "
        f"{MESH_RANKS} gloo ranks on {min(cards, MESH_RANKS)} card(s), rows [4 r, 4 r + 4) of {N_SLOTS} a rank: (a) "
        "phase 4's models (drawn on each rank from its seeds) and traffic, bf16, paged, ragged auto, pipelined; "
        f"(b) 8e's float32 cut ({F32_TARGET_LAYERS} + {F32_DRAFT_LAYERS} layers)")
    gc.collect()
    torch.cuda.empty_cache()
    traffic = list(zip(ctx["prompts"], ctx["max_new"], ctx["seeds"]))
    ctx_mp = mp.get_context("spawn")
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = ctx_mp.Queue()
        procs = [ctx_mp.Process(target=_pool_mesh_rank, args=(r, MESH_RANKS, f"{tmp}/init", traffic, out))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        try:
            for _ in range(MESH_RANKS):
                rank, ok, payload = out.get(timeout=RANK_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f"8g: rank {rank} failed:\n{payload}")
                got[rank] = payload
        except queue.Empty:
            raise RuntimeError(f"8g: {MESH_RANKS - len(got)} of {MESH_RANKS} ranks did not finish within "
                               f"{RANK_TIMEOUT_S} s") from None
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"8g: rank exit codes {[p.exitcode for p in procs]}")
    ranks = [got[r] for r in range(MESH_RANKS)]
    res = {"ranks": MESH_RANKS, "cards": min(cards, MESH_RANKS), "devices": [r["a"]["device"] for r in ranks],
           "rows": [r["a"]["rows"] for r in ranks]}
    for part, want_tokens in (("a", ctx["tokens"]["pipelined"]), ("b", f32_tokens)):
        runs = [r[part] for r in ranks]
        r0 = runs[0]
        if any(r["outs"] != r0["outs"] for r in runs[1:]):
            raise RuntimeError(f"8g ({part}): the ranks returned different tokens or reasons")
        bad = [i for i, o in enumerate(r0["outs"]) if o["reason"] != "length" or len(o["tokens"]) != traffic[i][1]]
        if bad:
            raise RuntimeError(f"8g ({part}): requests {bad} did not finish with their max_new tokens")
        expected = [_mesh_checks({**r, "rank": i}, len(traffic), part) for i, r in enumerate(runs)]
        if sum(r["idle_passes"]["prefill"] for r in runs) != (MESH_RANKS - 1) * len(traffic):
            raise RuntimeError(f"8g ({part}): each admission's prefill must run on exactly one rank")
        tokens = [o["tokens"] for o in r0["outs"]]
        n_tokens = sum(map(len, tokens))
        wall = max(r["wall_s"] for r in runs)
        res[part] = {"matches": sum(a == b for a, b in zip(tokens, want_tokens)), "steps": r0["steps"],
                     "exchanges": [r["exchanges"] for r in runs], "idle_passes": [r["idle_passes"] for r in runs],
                     "launches": [r["launches"] for r in runs], "expected_launches": expected,
                     "counters": r0["counters"], "wall_s": [r["wall_s"] for r in runs],
                     "gather_s": [r["gather_s"] for r in runs], "tokens": n_tokens,
                     "tokens_per_s": n_tokens / wall,
                     "max_memory_allocated": [r["max_memory_allocated"] for r in runs]}
    a, b = res["a"], res["b"]
    log(f"  (a) ranks on {res['devices']}, rows {res['rows']}: both ranks return the same tokens and reasons; "
        f"{a['matches']} of {len(traffic)} requests equal phase 4's pipelined tokens (reported, not claimed: bf16 "
        f"rounds by the batch's shape, and a rank's passes are 4 rows, not 8); {a['steps']} steps")
    log(f"  (a) exchanges a rank {a['exchanges']} (the design's: one a draft pass, one a target pass, one a "
        f"boundary that admits; nothing else); idle passes a rank {a['idle_passes']}")
    log(f"  (a) launches a rank {a['launches']} (expected {a['expected_launches']})")
    log(f"  (a) wall a rank {', '.join(f'{w:.4f}' for w in a['wall_s'])} s (in all_gather_object, the wait for "
        f"the other rank included: {', '.join(f'{g:.4f}' for g in a['gather_s'])} s), {a['tokens']} tokens = "
        f"{a['tokens_per_s']:.3f} tok/s aggregate (phase 4 pipelined: {phase4['pipelined']['wall_s']:.4f} s, "
        f"{phase4['pipelined']['tokens_per_s']:.3f} tok/s; "
        f"{'two ranks share one card: not a speed across cards' if cards < MESH_RANKS else 'a card a rank'}); "
        "max_memory_allocated a rank " + ", ".join(f"{m / 2**30:.3f} GiB" for m in a["max_memory_allocated"]))
    log(f"  (b) float32: {b['matches']} of {len(traffic)} requests equal 8e's single-process engine's tokens; "
        f"exchanges a rank {b['exchanges']}; launches a rank {b['launches']} (expected as in (a)); wall a rank "
        + ", ".join(f"{w:.4f}" for w in b["wall_s"]) + " s")
    if b["matches"] != len(traffic):
        bad = [i for i, (x, y) in enumerate(zip([o["tokens"] for o in ranks[0]["b"]["outs"]], f32_tokens)) if x != y]
        raise RuntimeError(f"8g (b): requests {bad} differ from 8e's single-process float32 tokens")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 8g took {res['seconds']:.1f} s")
    return res


def _profile_device_verify(torch, eng, prompt):
    """One step of ``eng`` (verify_on_device) under torch.profiler: the
    verifier's window is a record_function range around each
    ``_verify_device`` call; the device kernels that start inside it are the
    verifier's (the tree pass's results reached the host before it began,
    and it ends by reading its results back)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    inner = eng._verify_device

    def marked(tree, solver):
        with record_function("verify_on_device"):
            return inner(tree, solver)

    eng._verify_device = marked
    stream = eng.new_stream(prompt)
    eng.step(stream)  # a first step outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(stream)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del eng._verify_device
    events = list(prof.events())
    spans = [e.time_range for e in events if e.name == "verify_on_device"
             and e.device_type == torch.autograd.DeviceType.CPU]
    if len(spans) != 1:
        raise RuntimeError(f"expected one verification in the profiled step, saw {len(spans)}")
    r0, r1 = spans[0].start, spans[0].end
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and r0 <= e.time_range.start <= r1 and e.name != "verify_on_device"]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise RuntimeError("no device kernel ran inside the verifier: it did not verify on the card")
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    step_busy = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "verify_on_device") / 1e3
    host_ms = (r1 - r0) / 1e3
    log(f"  profile of one step: wall {wall_ms:.2f} ms, device busy {step_busy:.2f} ms; the verifier: "
        f"{len(kernels)} kernels + {len(device) - len(kernels)} copies, device busy {busy:.3f} ms, host span "
        f"{host_ms:.2f} ms ({100 * host_ms / wall_ms:.1f} % of the step)")
    return {"step_wall_ms": wall_ms, "step_device_busy_ms": step_busy, "verify_kernels": len(kernels),
            "verify_copies": len(device) - len(kernels), "verify_device_ms": busy, "verify_host_ms": host_ms}


def phase_device_verify(torch, tcfg, tp, dcfg, dp, main_path):
    """8c: phase 3's pair through SpeculativeEngine(verify_on_device=True):
    one request of 32 tokens with specinfer, one with spectr; tree_attention
    launches exact; every verification on the card."""
    log("== phase 8c: SpeculativeEngine(verify_on_device=True), full-width granite-8b + draft, bf16")
    import numpy as np

    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine

    t_phase = time.perf_counter()
    layers = (tcfg.n_layers, dcfg.n_layers)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab, size=8).tolist()  # phase 3's first prompt
    results, total = {}, 0
    for verifier in ("specinfer", "spectr"):
        eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig(verifier, 2, 2, 2, 1024, seed=0,
                                                                 verify_on_device=True), SamplingParams(1.0, 1.0))
        calls = [0]
        inner = eng._verify_device

        def counted(tree, solver, inner=inner, calls=calls):
            calls[0] += 1
            return inner(tree, solver)

        eng._verify_device = counted
        outs, wall, launches, be = _run_engine(torch, eng, [prompt], 32, layers)
        if calls[0] != eng.counters["blocks"]:
            raise RuntimeError(f"{verifier}: {calls[0]} device verifications for {eng.counters['blocks']} steps")
        total += launches
        results[verifier] = {"tokens_per_s": 32 / wall, "wall_s": wall, "block_efficiency": be,
                             "launches": launches, "steps": eng.counters["blocks"]}
        log(f"  {verifier} on the card: {32 / wall:.3f} tok/s, block_efficiency {be:.4f}, {eng.counters['blocks']} "
            f"steps, all verified on the card, tree_attention launches {launches} (phase 3's host specinfer: "
            f"{main_path['specinfer']['tokens_per_s']:.3f} tok/s); {outs[0]}")
    eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=1,
                                                             verify_on_device=True), SamplingParams(1.0, 1.0))
    results["profile"] = _profile_device_verify(torch, eng, prompt)
    results["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 8c took {results['seconds']:.1f} s")
    return results, total


def phase_solver_laws(torch):
    """8d: each device solver on V = 6 with a CUDA generator against the numpy
    oracle's output_dist, and the tree walk's block law against
    verify_topdown_output_dist.  A failure raises."""
    log(f"== phase 8d: the device solvers' laws on the card ({LAW_DRAWS} draws, atol {LAW_ATOL:.4f}; the tree walk "
        f"{WALK_DRAWS} draws, worst block < {WALK_WORST})")
    import numpy as np

    from repro_torch.core.enumerate import RandomModel
    from repro_torch.core.otlp import OTLP_SOLVERS
    from repro_torch.core.otlp_device import SOLVERS_DEVICE, verify_topdown_batched
    from repro_torch.core.trees import attach_target, build_delayed_tree
    from repro_torch.core.verify import verify_topdown_output_dist

    t_phase = time.perf_counter()
    V, n = 6, LAW_DRAWS
    rng = np.random.default_rng(3)
    p, q = rng.dirichlet(np.ones(V)), rng.dirichlet(np.ones(V))
    gen = torch.Generator(device="cuda").manual_seed(0)
    P = torch.tensor(p, dtype=torch.float32, device="cuda")[None].repeat(n, 1)
    Q = torch.tensor(q, dtype=torch.float32, device="cuda")[None].repeat(n, 1)
    valid = torch.ones((n, 2), dtype=torch.bool, device="cuda")
    results = {}
    for solver in ("nss", "naive", "spectr", "specinfer", "khisti"):
        for xs in ([1, 4], [0, 5]):
            want = OTLP_SOLVERS[solver][1](p, q, xs)
            X = torch.tensor([xs], device="cuda").repeat(n, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = SOLVERS_DEVICE[solver](P, Q, X, valid, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if not ys.is_cuda:
                raise RuntimeError(f"{solver} did not solve on the card")
            err = float(np.abs(np.bincount(ys.cpu().numpy(), minlength=V) / n - want).max())
            results[f"{solver} xs={xs}"] = {"max_abs_err": err, "ms": ms}
            log(f"  {solver:9s} xs={xs}: max |freq - law| {err:.4f} ({n} problems in one call, {ms:.2f} ms wall)")
            if err > LAW_ATOL:
                raise RuntimeError(f"{solver} xs={xs}: the card's law is {err} from the oracle's (atol {LAW_ATOL})")
    model = RandomModel(4, seed=5, divergence=0.6)
    tree = attach_target(build_delayed_tree(np.random.default_rng(0), model.q, 2, 1, 1), model.p)
    N, m = tree.n_nodes, 8
    arrs = [np.full(m, -1, np.int64), np.full(m, -1, np.int64), np.zeros((m, 4), np.float32),
            np.zeros((m, 4), np.float32)]
    arrs[0][:N], arrs[1][:N], arrs[2][:N], arrs[3][:N] = tree.tokens, tree.parent, tree.p, tree.q
    arrs = [torch.as_tensor(a, device="cuda")[None].expand((WALK_DRAWS,) + a.shape) for a in arrs]
    for solver in ("specinfer", "spectr", "naivetree"):
        want = verify_topdown_output_dist(tree, solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_tok, n_acc, corr = verify_topdown_batched(*arrs, gen, solver=solver, max_depth=4, max_children=4)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got: dict = {}
        for row, k, c in zip(out_tok.tolist(), n_acc.tolist(), corr.tolist()):
            blk = tuple(row[:k]) + (c,)
            got[blk] = got.get(blk, 0) + 1.0 / WALK_DRAWS
        worst = max(abs(want.get(k, 0) - got.get(k, 0)) for k in set(want) | set(got))
        results[f"walk {solver}"] = {"worst": worst, "ms": ms}
        log(f"  tree walk {solver:9s}: worst |freq - law| over blocks {worst:.4f} ({WALK_DRAWS} trees in one "
            f"batched call, {ms:.2f} ms wall)")
        if worst > WALK_WORST:
            raise RuntimeError(f"tree walk {solver}: the card's block law is {worst} from the oracle's")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 8d took {seconds:.1f} s")
    return {"laws": results, "seconds": seconds}


F32_TARGET_LAYERS, F32_DRAFT_LAYERS = 4, 1


def phase_float32_match(torch):
    """8e: granite-8b at full width cut to 4 target layers and a 1-layer
    draft, float32: how many of 3 streams the batched engine serves as the
    single-stream engine does, and how many of 12 the sharded engine serves
    as the unsharded one does (ROADMAP queue 3).  Launch counts exact;
    the match counts are reported, not claimed."""
    log(f"== phase 8e: granite-8b at full width, {F32_TARGET_LAYERS} target and {F32_DRAFT_LAYERS} draft layers, "
        f"float32: batched == single-stream, sharded == unsharded")
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine

    t_phase = time.perf_counter()
    full = get_config("granite-8b")
    tcfg = full.replace(n_layers=F32_TARGET_LAYERS, dtype="float32")
    dcfg = make_draft_cfg(full).replace(n_layers=F32_DRAFT_LAYERS, dtype="float32")
    tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
    dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    layers = (tcfg.n_layers, dcfg.n_layers)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(N_REQUESTS)]
    max_new = [16 + (32 * i) // (N_REQUESTS - 1) for i in range(N_REQUESTS)]
    seeds = [100 + i for i in range(N_REQUESTS)]
    sampling = SamplingParams(1.0, 1.0)
    unsharded = BatchedSpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024), sampling,
                                         n_slots=N_SLOTS, paged=True, block_size=64, pipeline=True)
    toks_u, res_u = _serve_batched(torch, unsharded, prompts, max_new, seeds, layers, need_both=False)
    toks_s, res_s = _serve_batched(torch, _sharded_engine(tcfg, tp, dcfg, dp, True), prompts, max_new, seeds,
                                   layers, need_both=False)
    single_launches, singles = 0, []
    for i in range(3):
        eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=seeds[i]),
                                sampling)
        outs, _, launches, _ = _run_engine(torch, eng, [prompts[i]], max_new[i], layers)
        single_launches += launches
        singles.append(_first_divergence(outs[0], toks_u[i]))
    results = {"batched_matches_single_of_3": sum(d is None for d in singles),
               "first_diverging_token": singles,
               "sharded_matches_unsharded_of_12": sum(a == b for a, b in zip(toks_s, toks_u)),
               "unsharded": res_u, "sharded": res_s, "unsharded_tokens": toks_u}
    log(f"  float32: batched == single-stream for {results['batched_matches_single_of_3']} of 3 streams (first "
        f"diverging tokens {singles}); sharded == unsharded for {results['sharded_matches_unsharded_of_12']} of "
        f"{N_REQUESTS}; block_efficiency {res_u['block_efficiency']:.4f} unsharded, "
        f"{res_s['block_efficiency']:.4f} sharded; launches exact")
    del tp, dp, unsharded, eng
    gc.collect()
    torch.cuda.empty_cache()
    results["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 8e took {results['seconds']:.1f} s")
    return results, [res_u["launches"], res_s["launches"]], single_launches


# ------------------------------------------------ phase 9: encoder-decoder, VLM ---

FAMILY_ARCHES = ("whisper-medium", "internvl2-26b")
# phase 9b's target cut from 48 layers to 24, to keep the script within half its time limit
# once phase 12 was added (PR 22); its draft is the full config's
FAMILY_TARGET_LAYERS = {"internvl2-26b": 24}
# profiler ranges around what the two families run outside any kernel (the plain gqa_attend, as in
# JAX): the Whisper encoder's layers, and each decoder layer's cross-attention core
ENCODER_RANGE, CROSS_RANGE = "plain encoder layer", "plain cross-attention"
CARD_BYTES = 80e9


def _modality(torch, cfg, seed):
    """A request's seeded modality input on the card, in ``cfg``'s dtype:
    Whisper's frame embeddings (1, enc_len, d) as ``enc_embeds``, InternVL's
    patch embeddings (1, n_patches, d) as ``embeds``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.arch_type == "encdec":
        return {"enc_embeds": torch.randn(1, cfg.enc_len, cfg.d_model, generator=gen, device="cuda").to(cfg.tdtype)}
    return {"embeds": torch.randn(1, cfg.n_patches, cfg.d_model, generator=gen, device="cuda").to(cfg.tdtype)}


@contextlib.contextmanager
def _plain_attention_ranges(torch):
    """Label, for the profiler, the encoder's layers (the blocks called
    without a mask) and every cross-attention core (``gqa_attend`` outside
    the encoder) by patching models/transformer.py's names meanwhile.
    Yields the count of labelled calls by range, for the caller to hold."""
    from torch.profiler import record_function

    from repro_torch.models import transformer

    block, attend = transformer._attn_mlp_block, transformer.gqa_attend
    in_encoder = [False]
    calls = {ENCODER_RANGE: 0, CROSS_RANGE: 0}

    def labelled_block(p, cfg, x, positions, mask, *args, **kw):
        if mask is not None:
            return block(p, cfg, x, positions, mask, *args, **kw)
        in_encoder[0] = True
        calls[ENCODER_RANGE] += 1
        try:
            with record_function(ENCODER_RANGE):
                return block(p, cfg, x, positions, mask, *args, **kw)
        finally:
            in_encoder[0] = False

    def labelled_attend(q, k, v, mask):
        if in_encoder[0]:
            return attend(q, k, v, mask)
        calls[CROSS_RANGE] += 1
        with record_function(CROSS_RANGE):
            return attend(q, k, v, mask)

    transformer._attn_mlp_block, transformer.gqa_attend = labelled_block, labelled_attend
    try:
        yield calls
    finally:
        transformer._attn_mlp_block, transformer.gqa_attend = block, attend


def phase_families(torch):
    """9a/9b: whisper-medium and internvl2-26b at full width (9b's target cut to FAMILY_TARGET_LAYERS),
    each with its make_draft_cfg draft, bf16, through SpeculativeEngine:
    phase 3's traffic, each request given seeded frames (1, 1500, 1024) or
    256 patches (1, 256, 6144), launch counts exact; the prefill's wall,
    peak memory, a profile of one request.  Returns (results, launches)."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine

    results, total_launches = {}, 0
    for sub, arch in zip("ab", FAMILY_ARCHES):
        t_phase = time.perf_counter()
        full = get_config(arch)
        tcfg = full.replace(n_layers=FAMILY_TARGET_LAYERS.get(arch, full.n_layers))
        dcfg = make_draft_cfg(full)
        cut = "nothing cut" if tcfg.n_layers == full.n_layers else \
            f"the target cut from {full.n_layers} to {tcfg.n_layers} layers"
        log(f"== phase 9{sub}: {arch} at full width, {cut}, + draft, bf16, one stream")
        for role, cfg in (("target", tcfg), ("draft ", dcfg)):
            extra = (f" enc_layers={cfg.n_enc_layers} enc_len={cfg.enc_len}" if cfg.arch_type == "encdec"
                     else f" patches={cfg.n_patches}")
            log(f"{role} {cfg.name}: L={cfg.n_layers}{extra} d={cfg.d_model} H={cfg.n_heads} Hkv={cfg.n_kv_heads} "
                f"hd={cfg.hd} ff={cfg.d_ff} V={cfg.vocab} ({cfg.param_count() / 1e9:.2f} B params)")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tp = init_params(tcfg, torch.Generator(device="cuda").manual_seed(0))
        dp = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        log(f"weights drawn on the card in {time.perf_counter() - t0:.2f} s")
        layers = (tcfg.n_layers, dcfg.n_layers)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, tcfg.vocab, size=8).tolist() for _ in range(3)]
        kw = _modality(torch, tcfg, 2)
        sampling = SamplingParams(1.0, 1.0)
        warm = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=9), sampling)
        warm.generate(prompts[0], max_new=8, **kw)  # cuBLAS and allocator warm-up, not measured
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm.new_stream(prompts[0], **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res = {"prefill_wall_s": statistics.median(walls)}
        what = (f"encoder over {tcfg.enc_len} frames" if tcfg.arch_type == "encdec" else f"{tcfg.n_patches} patches")
        log(f"  prefill (the target's {what} + 7 tokens, the draft's 7 tokens): median wall "
            f"{res['prefill_wall_s'] * 1e3:.2f} ms of 3")
        for verifier, reqs in (("specinfer", prompts[:2]), ("traversal", prompts[2:])):
            eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig(verifier, 2, 2, 2, 1024, seed=0), sampling)
            outs, wall, launches, be = _run_engine(torch, eng, reqs, 32, layers, gen_kw=kw)
            total_launches += launches
            tokens = sum(len(o) for o in outs)
            c = eng.counters
            for r, out in enumerate(outs):
                log(f"  {verifier} req{r}: {out}")
            log(f"  {verifier} (2,2,2): block_efficiency={be:.4f} blocks={c['blocks']} "
                f"target_calls={c['target_calls']} draft_calls={c['draft_calls']} tokens={tokens} "
                f"wall={wall:.4f} s tokens/s={tokens / wall:.3f} tree_attention launches={launches} "
                f"(= {layers[0]} x {len(reqs) + c['target_calls']} + {layers[1]} x {len(reqs) + c['draft_calls']})")
            res[verifier] = {"block_efficiency": be, "wall_s": wall, "tokens_per_s": tokens / wall,
                             "launches": launches, "tokens": tokens, "steps": c["blocks"]}
        peak = torch.cuda.max_memory_allocated()
        log(f"  max_memory_allocated {peak / 2**30:.3f} GiB")
        if peak >= CARD_BYTES:
            raise RuntimeError(f"{arch}: peak memory {peak} bytes is not under {CARD_BYTES:.0f}")
        res["max_memory_allocated"] = peak
        eng = SpeculativeEngine(tcfg, tp, dcfg, dp, EngineConfig("specinfer", 2, 2, 2, 1024, seed=1), sampling)
        with _plain_attention_ranges(torch) as calls:
            res["profile"] = _profile(torch, eng, prompts[0], gen_kw=kw, labels=(ENCODER_RANGE, CROSS_RANGE))
        ranges = res["profile"]["ranges_ms"]
        log(f"  profile: plain encoder layers {ranges[ENCODER_RANGE]:.3f} ms in {calls[ENCODER_RANGE]} calls, "
            f"plain cross-attention cores {ranges[CROSS_RANGE]:.3f} ms in {calls[CROSS_RANGE]} calls, of device time")
        # the encoder runs once, in the target's prefill; a cross-attention core sits in every decoder
        # layer of every pass (the draft's too, over its zero cross cache); the VLM has neither
        c = eng.counters
        want = ({ENCODER_RANGE: tcfg.n_enc_layers,
                 CROSS_RANGE: layers[0] * (1 + c["target_calls"]) + layers[1] * (1 + c["draft_calls"])}
                if tcfg.arch_type == "encdec" else {ENCODER_RANGE: 0, CROSS_RANGE: 0})
        for label, n in want.items():
            if calls[label] != n or (n > 0) != (ranges[label] > 0):
                raise RuntimeError(f"{arch}: {label} ran {calls[label]} times for {ranges[label]:.3f} ms of "
                                   f"device time, expected {n} calls and {'some' if n else 'no'} device time")
        del tp, dp, warm, eng
        gc.collect()
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t_phase
        log(f"  phase 9{sub} took {res['seconds']:.1f} s")
        results[arch] = res
    return results, total_launches


def phase_family_reference(torch):
    """9c: the whisper-medium draft at full width (6 + 6 layers, d 512)
    given frames of its own width (1, 1500, 512), and the internvl2-26b
    draft cut to 2 layers given its 256 patches, float32, the card against
    the CPU (phase_reference).  Returns (worst relative error, launches);
    the launches, a prefill and a tree pass a layer, are checked."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.tree_attention import tree_attention
    from repro_torch.launch.serve import make_draft_cfg

    t_phase = time.perf_counter()
    worst, launches = 0.0, 0
    for arch, n_layers, seed in (("whisper-medium", None, 8), ("internvl2-26b", 2, 10)):
        cfg = make_draft_cfg(get_config(arch)).replace(dtype="float32")
        cut = "at full width" if n_layers is None else f"cut to {n_layers} layers"
        cfg = cfg if n_layers is None else cfg.replace(n_layers=n_layers)
        torch.cuda.synchronize()
        tree_attention.launches = 0
        worst = max(worst, phase_reference(torch, cfg, seed, f"phase 9c: the {arch} draft {cut}, with its "
                                           f"{'frames' if cfg.arch_type == 'encdec' else 'patches'}",
                                           _modality(torch, cfg, seed + 1)))
        torch.cuda.synchronize()
        if tree_attention.launches != 2 * cfg.n_layers:
            raise RuntimeError(f"tree_attention launched {tree_attention.launches} times in 9c, expected "
                               f"{2 * cfg.n_layers} (a prefill and a tree pass x layers)")
        launches += tree_attention.launches
    torch.cuda.empty_cache()
    log(f"  phase 9c took {time.perf_counter() - t_phase:.1f} s")
    return worst, launches

# ------------------------------------------------------- phase 10: training ---

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "granite-3-2b", 4, 1024, 20
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = \
    "qwen3-moe-235b-a22b", 1, 2, 512, 5
EXAMPLE_STEPS, EXAMPLE_V = 120, 256  # examples/serve_speculative.py


def _timed(torch, step_fn, times):
    """``step_fn`` with each call's wall (the card synchronised on both sides)
    appended to ``times``."""
    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return timed


def _zero_launches():
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _no_launches(counters, what):
    """Training reaches no hand-written kernel: every count must still be 0."""
    got = {name: fn.launches for name, fn in counters.items()}
    if any(got.values()):
        raise RuntimeError(f"{what} launched hand-written kernels: {got}")
    return got


def _busy_share(torch, fn, n):
    """Device-busy share of the wall of ``n`` calls of ``fn`` under
    torch.profiler (CUPTI): the summed kernel and copy time over the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "busy_share": busy / wall_ms, "top_kernels_ms": top}


def phase_train_dense(torch):
    """10a: granite-3-2b at full width, nothing cut, bf16, remat on, trained
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ SyntheticLM tokens through
    training/loop.train (AdamW lr 3e-4, warmup 1, cosine), every launch count
    0; then a 2-step profile and a checkpoint of the full parameters saved,
    loaded and compared bit for bit."""
    import gc

    import numpy as np

    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params, make_train_step
    from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import to_device, train
    from repro_torch.training.optim import AdamW, tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    n_params = cfg.param_count()
    log(f"== phase 10a: training {cfg.name} at full width, nothing cut: L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} ff={cfg.d_ff} V={cfg.vocab} ({n_params / 1e9:.2f} B params), "
        f"{cfg.dtype}, remat={cfg.remat}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    it = SyntheticLM(cfg.vocab, seed=0).batches(TRAIN_BATCH, TRAIN_SEQ, seed=0)
    t0 = time.perf_counter()
    batches = [next(it) for _ in range(TRAIN_STEPS)]
    log(f"  {TRAIN_STEPS} SyntheticLM batches drawn on the host in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    before = {"embed": params["embed"].clone(), "wq": params["blocks"]["attn"]["wq"][0].clone()}
    opt = AdamW(lr=3e-4, total_steps=TRAIN_STEPS, warmup_steps=1)
    times, lines = [], []
    counters = _zero_launches()
    params, losses = train(cfg, iter(batches), steps=TRAIN_STEPS, log_every=1, opt=opt, params=params,
                           train_step=_timed(torch, make_train_step(cfg, opt), times), log_fn=lines.append,
                           device="cuda")
    torch.cuda.synchronize()
    launches = _no_launches(counters, "10a training")
    peak = torch.cuda.max_memory_allocated()
    for line in lines[:3] + ["..."] + lines[-3:]:
        log(f"  {line}")
    vals = [l for _, l in losses]
    first, last5 = vals[0], statistics.fmean(vals[-5:])
    if not all(np.isfinite(vals)) or not last5 < first:
        raise RuntimeError(f"10a: losses {vals} are not finite or do not fall (last 5 mean {last5} vs first {first})")
    changed = not (torch.equal(before["embed"], params["embed"]) or torch.equal(before["wq"], params["blocks"]["attn"]["wq"][0]))
    if not changed:
        raise RuntimeError("10a: the parameters did not change")
    if peak >= CARD_BYTES:
        raise RuntimeError(f"10a: peak memory {peak} bytes is not under {CARD_BYTES:.0f}")
    step_s = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / step_s / PEAK_FLOPS["bfloat16"]
    res = {"losses": vals, "first_loss": first, "last5_mean_loss": last5, "step_ms": [t * 1e3 for t in times],
           "median_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s, "model_flop_share": mfu,
           "max_memory_allocated": peak, "launches": launches, "params": n_params}
    log(f"  loss {first:.4f} -> last-5 mean {last5:.4f}; median step {step_s * 1e3:.2f} ms (first "
        f"{times[0] * 1e3:.2f} ms), {tokens / step_s:.1f} tok/s, model-FLOP share 6*N*tokens/step/peak "
        f"{100 * mfu:.2f} % of {PEAK_FLOPS['bfloat16']:.3g} FLOP/s; peak {peak / 2**30:.3f} GiB; "
        f"kernel launches {launches}")
    del before
    step_fn = make_train_step(cfg, opt)
    state = {"p": params, "o": opt.init(params)}
    batch = to_device(batches[0], "cuda")

    def one_step():
        state["p"], state["o"], _ = step_fn(state["p"], state["o"], batch)

    one_step()  # the profiled steps' optimizer state is warm, as in the loop
    res["profile"] = _busy_share(torch, one_step, 2)
    log(f"  profile of 2 steps: wall {res['profile']['wall_ms']:.2f} ms, device busy "
        f"{res['profile']['device_busy_ms']:.2f} ms ({100 * res['profile']['busy_share']:.1f} %)")
    for name, t in res["profile"]["top_kernels_ms"]:
        log(f"    device {t:9.3f} ms  {name[:100]}")
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "granite-3-2b.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, params, step=TRAIN_STEPS)
        save_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        loaded, step = load_checkpoint(path, template=params, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    same = step == TRAIN_STEPS and all(a.dtype == b.dtype and torch.equal(a, b)
                                       for a, b in zip(tree_leaves(loaded), tree_leaves(params)))
    if not same:
        raise RuntimeError("10a: the loaded checkpoint differs from the saved parameters")
    res["checkpoint"] = {"bytes": size, "save_s": save_s, "load_s": load_s}
    log(f"  checkpoint of the full parameters: {size / 2**30:.3f} GiB, saved in {save_s:.2f} s, loaded to the card "
        f"in {load_s:.2f} s, equal bit for bit")
    del params, loaded
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10a took {res['seconds']:.1f} s")
    return res


def phase_train_moe(torch):
    """10b: qwen3-moe-235b-a22b at full width cut from 94 layers to
    MOE_TRAIN_LAYERS (two layers' parameters, gradients and AdamW state fit
    no card), bf16, the capacity-factor dispatch, MOE_TRAIN_STEPS steps of
    MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens; the share of (token, choice)
    pairs dropped each step."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import forward, make_train_step
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import train
    from repro_torch.training.optim import AdamW

    t_phase = time.perf_counter()
    full = get_config(MOE_TRAIN_ARCH)
    cfg = full.replace(n_layers=MOE_TRAIN_LAYERS)
    log(f"== phase 10b: training {cfg.name} at full width, cut from {full.n_layers} to {cfg.n_layers} layer(s): "
        f"d={cfg.d_model} H={cfg.n_heads} Hkv={cfg.n_kv_heads} E={cfg.n_experts} top-{cfg.top_k} ff={cfg.d_ff} "
        f"V={cfg.vocab} ({cfg.param_count() / 1e9:.2f} B params), capacity_factor {cfg.capacity_factor}, "
        f"{MOE_TRAIN_STEPS} steps of {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens")
    it = SyntheticLM(cfg.vocab, seed=0).batches(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed=0)
    batches = [next(it) for _ in range(MOE_TRAIN_STEPS)]
    n = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    C = moe.moe_capacity(n, cfg, train=True)
    # each step's drops are read outside its timing: an untimed no-grad forward pass with train=True on the
    # step's parameters and tokens, moe.route counted (the step's own pass and remat's recompute route the
    # same pairs), so the timed step runs the program's own route
    calls, route = [], moe.route

    def counted_route(p, cfg_, xf):
        out = route(p, cfg_, xf)
        calls.append(((out[3] >= C).sum(), out[3].numel()))
        return out

    shares = []
    opt = AdamW(lr=3e-4, total_steps=MOE_TRAIN_STEPS, warmup_steps=1)
    times, lines = [], []
    timed = _timed(torch, make_train_step(cfg, opt), times)

    def step(params, opt_state, batch):
        calls.clear()
        moe.route = counted_route
        try:
            with torch.no_grad():
                forward(params, cfg, batch["tokens"], mode="full", train=True)
        finally:
            moe.route = route
        shares.append(sum(int(d) for d, _ in calls) / sum(p for _, p in calls))
        return timed(params, opt_state, batch)

    torch.cuda.reset_peak_memory_stats()
    counters = _zero_launches()
    params, losses = train(cfg, iter(batches), steps=MOE_TRAIN_STEPS, log_every=1, opt=opt, seed=0,
                           train_step=step, log_fn=lines.append, device="cuda")
    torch.cuda.synchronize()
    launches = _no_launches(counters, "10b training")
    peak = torch.cuda.max_memory_allocated()
    vals = [l for _, l in losses]
    for line in lines:
        log(f"  {line}")
    if not all(np.isfinite(vals)):
        raise RuntimeError(f"10b: losses {vals} are not finite")
    if peak >= CARD_BYTES:
        raise RuntimeError(f"10b: peak memory {peak} bytes is not under {CARD_BYTES:.0f}")
    res = {"losses": vals, "capacity": C, "dropped_share": shares, "step_ms": [t * 1e3 for t in times],
           "median_step_ms": statistics.median(times) * 1e3, "max_memory_allocated": peak, "launches": launches,
           "routings_counted_per_step": len(calls)}
    log(f"  capacity {C} slots an expert for {n} tokens x top-{cfg.top_k}; dropped share of (token, choice) pairs "
        f"by step {', '.join(f'{s:.4f}' for s in shares)} (read outside the timed steps, "
        f"{res['routings_counted_per_step']} routing(s) a step); median step {res['median_step_ms']:.2f} ms; peak "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10b took {res['seconds']:.1f} s")
    return res


def phase_train_reference(torch):
    """10c: one train step's loss and gradients of every list_arches() smoke
    config in float32, the card against the CPU, from the same parameters
    and batch: the loss within 1e-4 relative, each gradient leaf within 1e-3
    of its own largest |value|.  Every launch count stays 0."""
    import numpy as np

    from repro_torch.configs import get_smoke, list_arches
    from repro_torch.models.transformer import init_params, loss_and_grads
    from repro_torch.training.loop import to_device
    from repro_torch.training.optim import tree_leaves, tree_map

    t_phase = time.perf_counter()
    log("== phase 10c: a train step of every smoke config, float32, the card against the CPU")
    worst_loss = worst_grad = 0.0
    counters = _zero_launches()
    for i, arch in enumerate(list_arches()):
        cfg = get_smoke(arch).replace(dtype="float32")
        cpu_params = init_params(cfg, torch.Generator().manual_seed(i))
        rng = np.random.default_rng(i)
        toks = rng.integers(0, cfg.vocab, (2, 17))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.arch_type == "encdec":
            batch["enc_embeds"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
        elif cfg.arch_type == "vlm":
            batch["embeds"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out = {}
        for dev, params in (("cuda", tree_map(lambda t: t.to("cuda"), cpu_params)), ("cpu", cpu_params)):
            loss, grads = loss_and_grads(params, cfg, to_device(batch, dev))
            out[dev] = (loss.item(), [g.cpu() for g in tree_leaves(grads)])
        (lc, gc_), (lh, gh) = out["cuda"], out["cpu"]
        rel_loss = abs(lc - lh) / abs(lh)
        rel_grad = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) if b.abs().max() > 0
                       else a.abs().max().item() for a, b in zip(gc_, gh))
        worst_loss, worst_grad = max(worst_loss, rel_loss), max(worst_grad, rel_grad)
        log(f"  {arch:28s} ({cfg.arch_type:6s}) loss {lh:.6f}: |card - cpu| / |cpu| {rel_loss:.3e}; worst gradient "
            f"leaf max|card - cpu| / max|cpu| {rel_grad:.3e} over {len(gh)} leaves")
        if not np.isfinite(lc) or rel_loss > 1e-4 or rel_grad > 1e-3:
            raise RuntimeError(f"10c {arch}: the card's train step disagrees with the CPU's "
                               f"(loss {rel_loss}, gradients {rel_grad})")
    launches = _no_launches(counters, "10c")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 10c took {seconds:.1f} s (worst loss {worst_loss:.3e}, worst gradient leaf {worst_grad:.3e}; "
        f"kernel launches {launches})")
    return {"worst_loss_rel": worst_loss, "worst_grad_rel": worst_grad, "seconds": seconds}


def phase_train_then_serve(torch):
    """10d: examples/serve_speculative.py's own models on the card: its
    4-layer d 192 target (6/2 heads of 32) and 1-layer d 96 draft (2/1
    heads of 48) at V 256, float32, trained EXAMPLE_STEPS steps each on
    SyntheticLM(256, seed 3) (no kernel launched), then 4 requests of 48
    tokens through SpeculativeEngine, specinfer at (2, 2, 2), temperature
    0.9, max_cache 512: every masked pass goes through the tree kernel's
    head_dim-32 and -48 instances, launch counts exact.  Returns (results,
    launches)."""
    import gc

    import numpy as np

    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import EngineConfig, SamplingParams, SpeculativeEngine
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import train

    t_phase = time.perf_counter()
    log("== phase 10d: examples/serve_speculative.py's own models (target 6/2 heads of 32, draft 2/1 heads "
        "of 48) on the card: train a target and a draft, then serve them")
    tcfg = ModelConfig(name="target", n_layers=4, d_model=192, n_heads=6, n_kv_heads=2, d_ff=384,
                       vocab=EXAMPLE_V, dtype="float32")
    dcfg = ModelConfig(name="draft", n_layers=1, d_model=96, n_heads=2, n_kv_heads=1, d_ff=192,
                       vocab=EXAMPLE_V, dtype="float32")
    lm = SyntheticLM(EXAMPLE_V, seed=3)
    res = {}
    counters = _zero_launches()
    trained = {}
    for role, cfg, data_seed, lr in (("target", tcfg, 1, 2e-3), ("draft", dcfg, 7, 3e-3)):
        t0 = time.perf_counter()
        lines = []
        trained[role], losses = train(cfg, lm.batches(8, 64, seed=data_seed), steps=EXAMPLE_STEPS, lr=lr,
                                      log_every=40, log_fn=lines.append, device="cuda")
        torch.cuda.synchronize()
        res[role] = {"losses": losses, "seconds": time.perf_counter() - t0, "params": cfg.param_count()}
        log(f"  {role} ({cfg.param_count() / 1e6:.2f} M params) {EXAMPLE_STEPS} steps in "
            f"{res[role]['seconds']:.2f} s: " + "; ".join(lines))
        if not all(np.isfinite(l) for _, l in losses) or not losses[-1][1] < losses[0][1]:
            raise RuntimeError(f"10d: the {role}'s loss does not fall: {losses}")
    _no_launches(counters, "10d training")
    rng = np.random.default_rng(0)
    prompts = [lm.sample(rng, 12).tolist() for _ in range(4)]
    eng = SpeculativeEngine(tcfg, trained["target"], dcfg, trained["draft"],
                            EngineConfig(verifier="specinfer", K=2, L1=2, L2=2, max_cache=512, seed=0),
                            SamplingParams(0.9, 1.0))
    outs, wall, launches, be = _run_engine(torch, eng, prompts, 48, (tcfg.n_layers, dcfg.n_layers))
    c = eng.counters
    for r, out in enumerate(outs):
        log(f"  req{r}: prompt={prompts[r][:6]}.. -> {out[:10]}..")
    res.update(block_efficiency=be, target_calls=c["target_calls"], tokens=4 * 48, wall_s=wall, launches=launches,
               tokens_per_target_call=4 * 48 / c["target_calls"])
    log(f"  block_efficiency={be:.4f} target_calls={c['target_calls']} for {4 * 48} tokens "
        f"({res['tokens_per_target_call']:.2f} tokens a target call), wall {wall:.3f} s, tree_attention "
        f"launches {launches} (= {tcfg.n_layers} x {4 + c['target_calls']} + {dcfg.n_layers} x "
        f"{4 + c['draft_calls']})")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10d took {res['seconds']:.1f} s")
    return res, launches


# ---------------------------------------------------------------- phase 11: the dry run ---

# the dry run's worker processes: each (arch x shape) entry is host-bound Python on fake tensors
DRY_JOBS = 8
# the real builds phase 11 holds the dry run's bytes against: granite-8b serving 8 rows of a
# 4096-slot cache (bf16), and one granite-3-2b train step of 1 x 1024 tokens
DRY_DECODE = {"seq": 4096, "batch": 8, "kind": "decode"}
DRY_TRAIN = {"seq": 1024, "batch": 1, "kind": "train"}
DRY_TOLERANCE_RULE = "|memory_allocated increase - resident_bytes| <= 0.1 % of resident_bytes + 1 MiB"
# the table's longest entries at full depth (~116 and ~72 s of host time on the H100's machine: the
# RG-LRU scan runs in Python a layer; then mamba2-2.7b's 64 layers, 55.5 and 48.2 s in PR 24's proof
# run), run at a cut depth so that the table ends with its other entries
DRY_CUT_LAYERS = {("recurrentgemma-2b", "prefill_32k"): 12, ("recurrentgemma-2b", "train_4k"): 12,
                  ("mamba2-2.7b", "prefill_32k"): 16, ("mamba2-2.7b", "train_4k"): 16}


def _real_bytes(torch, build):
    """(what ``build()`` returns, the increase of torch.cuda.memory_allocated()
    it left)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def _real_peak(torch, step):
    """torch.cuda.max_memory_allocated() over one ``step()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase_dry_run(torch):
    """11: launch/dryrun.py on every config x every shape (each step run on
    fake tensors, its FLOPs counted and its peak tracked; DRY_JOBS worker
    processes), one line an entry; then the bytes held on the card: a
    real granite-8b build (bf16 weights, a DRY_DECODE cache) against the
    dry run's resident_bytes of the same shape (DRY_TOLERANCE_RULE), the
    dry run's peak_bytes beside max_memory_allocated of one real decode
    step there (kernel 1 at every layer, launches exact) and of one real
    granite-3-2b train step of DRY_TRAIN (no kernel), reported, not gated.
    Returns (results, tree_attention launches)."""
    import gc

    from repro_torch.configs import get_config, list_arches
    from repro_torch.launch.dryrun import H100_BYTES, _line, dry_run_one, dry_run_table
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models.transformer import forward, init_cache, init_params, make_train_step
    from repro_torch.training.optim import AdamW

    t_phase = time.perf_counter()
    jobs = min(DRY_JOBS, os.cpu_count() or 1)
    log(f"== phase 11: the dry run (launch/dryrun.py, every step run, {jobs} processes), then its bytes against "
        "real builds on the card")
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  torch.cuda.get_device_properties(0).total_memory {total}; launch/dryrun.py's H100_BYTES {H100_BYTES}")
    if torch.cuda.get_device_name(0) == "NVIDIA H100 80GB HBM3" and total != H100_BYTES:
        raise RuntimeError(f"11: H100_BYTES {H100_BYTES} is not this card's total_memory {total}")
    entries = [(arch, shape, True, None) + ((get_config(arch).replace(n_layers=DRY_CUT_LAYERS[arch, shape]),)
                                             if (arch, shape) in DRY_CUT_LAYERS else ())
               for arch in list_arches() for shape in SHAPES]
    # phase 12c's entries on the production meshes (40-160 s each) and the recurrent families'
    # prefill and train steps, which run their scans in Python (40-100 s each; the rest 2-35 s),
    # start first, so the processes finish together
    mesh_entries = [(arch, shape, True, multi_pod) for arch, shape in MESH_DRY_RUNS for multi_pod in (False, True)]
    entries = mesh_entries + entries
    order = sorted(range(len(entries)), key=lambda i: (entries[i][3] is None, get_config(entries[i][0]).arch_type
                                                      not in ("ssm", "hybrid")
                                                      or SHAPES[entries[i][1]]["kind"] == "decode"))
    done = dict(zip(order, dry_run_table([entries[i] for i in order], jobs)))
    table, failed = [], []
    for i in range(len(mesh_entries), len(entries)):
        status, r = done[i]
        if len(entries[i]) > 4:
            r["cut_to_layers"] = entries[i][4].n_layers
        log("  " + _line(status, r) + (f" [cut to {r['cut_to_layers']} of {get_config(r['arch']).n_layers} "
                                       "layers]" if "cut_to_layers" in r else ""))
        (table if status == "OK" else failed).append(r)
    if failed:
        raise RuntimeError(f"11: {len(failed)} dry runs failed: {[(r['arch'], r['shape']) for r in failed]}")
    res = {"table": table, "table_seconds": time.perf_counter() - t_phase, "jobs": jobs,
           "mesh_runs": [done[i] for i in range(len(mesh_entries))]}
    log(f"  {len(table)} dry runs (and phase 12c's {len(mesh_entries)}) in {res['table_seconds']:.1f} s")

    cfg = get_config("granite-8b")
    dry = dry_run_one("granite-8b", DRY_DECODE)
    B, S = DRY_DECODE["batch"], DRY_DECODE["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    (params, cache, tokens), real = _real_bytes(torch, lambda: (
        init_params(cfg, torch.Generator(device="cuda").manual_seed(0)), init_cache(cfg, B, S, "cuda"),
        torch.randint(0, cfg.vocab, (B, 1), dtype=torch.int32, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))))
    diff = real - dry["resident_bytes"]
    limit = 1e-3 * dry["resident_bytes"] + 2**20
    log(f"  granite-8b decode {B} x {S}: memory_allocated increase {real} bytes, dry run resident_bytes "
        f"{dry['resident_bytes']} (params {dry['param_bytes']}, cache {dry['cache_bytes']}, inputs "
        f"{dry['input_bytes']}): difference {diff} bytes (limit {limit:.0f}: {DRY_TOLERANCE_RULE})")
    if abs(diff) > limit:
        raise RuntimeError(f"11: the dry run's resident bytes {dry['resident_bytes']} disagree with the card's "
                           f"{real} ({DRY_TOLERANCE_RULE})")
    base = torch.cuda.memory_allocated() - real
    counters = _zero_launches()
    peak = _real_peak(torch, lambda: forward(params, cfg, tokens, mode="decode", cache=cache)) - base
    launches = counters["tree_attention"].launches
    if launches != cfg.n_layers or any(fn.launches for name, fn in counters.items() if name != "tree_attention"):
        raise RuntimeError(f"11: one decode step launched {({n: f.launches for n, f in counters.items()})}, "
                           f"expected tree_attention x {cfg.n_layers}")
    res["decode"] = {"shape": DRY_DECODE, "resident_bytes": dry["resident_bytes"], "memory_allocated_increase": real,
                     "difference": diff, "limit": limit, "peak_bytes": dry["peak_bytes"],
                     "max_memory_allocated": peak, "peak_ratio": dry["peak_bytes"] / peak,
                     "flops_counted": dry["flops_counted"], "launches": launches}
    log(f"  one real decode step ({launches} tree_attention launches): max_memory_allocated {peak} bytes, dry run "
        f"peak_bytes {dry['peak_bytes']} (plain attention): ratio {res['decode']['peak_ratio']:.4f}")
    del params, cache, tokens
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("granite-3-2b")
    dry = dry_run_one("granite-3-2b", DRY_TRAIN)
    gen = torch.Generator(device="cuda").manual_seed(2)
    opt = AdamW(lr=1e-4)

    def build():
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (DRY_TRAIN["batch"], DRY_TRAIN["seq"]), dtype=torch.int32,
                             device="cuda", generator=gen)
        return params, opt.init(params), {"tokens": toks, "labels": toks.roll(-1, dims=1)}

    (params, state, batch), real = _real_bytes(torch, build)
    base = torch.cuda.memory_allocated() - real
    step = make_train_step(cfg, opt)
    counters = _zero_launches()
    peak = _real_peak(torch, lambda: step(params, state, batch)) - base
    _no_launches(counters, "11 train step")
    res["train"] = {"shape": DRY_TRAIN, "resident_bytes": dry["resident_bytes"], "memory_allocated_increase": real,
                    "peak_bytes": dry["peak_bytes"], "max_memory_allocated": peak,
                    "peak_ratio": dry["peak_bytes"] / peak, "flops_counted": dry["flops_counted"]}
    log(f"  granite-3-2b train step {DRY_TRAIN['batch']} x {DRY_TRAIN['seq']}: memory_allocated increase {real} "
        f"bytes, dry run resident_bytes {dry['resident_bytes']} (params {dry['param_bytes']}, AdamW "
        f"{dry['opt_bytes']}); max_memory_allocated {peak} bytes, dry run peak_bytes {dry['peak_bytes']}: ratio "
        f"{res['train']['peak_ratio']:.4f} (no kernel launched)")
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11 took {res['seconds']:.1f} s")
    return res, launches


# phase 12: the 4-layer float32 cut of granite-8b held against the plain step, its batches and
# AdamW (eps 1e-3 bounds the step's derivative in a near-zero gradient, as in
# tests/test_torch_distributed.py), and phase 12c's dry runs
MESH_TRAIN_STEPS = 5
MESH_CHECK_LAYERS, MESH_CHECK_BATCH, MESH_CHECK_SEQ, MESH_CHECK_STEPS = 4, 2, 256, 3
MESH_CHECK_OPT = {"lr": 1e-3, "eps": 1e-3}
MESH_DRY_RUNS = [("qwen3-moe-235b-a22b", "train_4k"), ("granite-8b", "train_4k"), ("granite-8b", "decode_32k")]


def _mesh_check_run(torch, mesh, device):
    """MESH_CHECK_STEPS float32 steps of granite-8b cut to MESH_CHECK_LAYERS
    layers from seed 0: the plain step when ``mesh`` is None, else the
    sharded step over ``mesh``.  Returns ({path: leaf on the CPU}, losses)
    (gathered whole on every rank of ``mesh``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import gather
    from repro_torch.launch.train import make_sharded_train_step, place_params
    from repro_torch.models.transformer import init_params, make_train_step
    from repro_torch.training.loop import to_device
    from repro_torch.training.optim import AdamW

    cfg = get_config("granite-8b").replace(n_layers=MESH_CHECK_LAYERS, dtype="float32")
    rng = np.random.default_rng(0)
    opt = AdamW(**MESH_CHECK_OPT)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    if mesh is not None:
        params = place_params(mesh, cfg, params)
    state = opt.init(params)
    step = make_train_step(cfg, opt) if mesh is None else make_sharded_train_step(cfg, opt, mesh)
    losses = []
    for _ in range(MESH_CHECK_STEPS):
        toks = rng.integers(0, cfg.vocab, (MESH_CHECK_BATCH, MESH_CHECK_SEQ + 1))
        batch = to_device({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, device)
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    whole = gather(params) if mesh is not None else params

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in flat(tree[key], f"{prefix}{key}/").items()}
        return {prefix[:-1]: tree.detach().cpu()}

    return flat(whole), losses


def _mesh_check_errors(torch, got, want) -> float:
    """The largest leaf difference as a share of that leaf's largest |value|."""
    if sorted(got) != sorted(want):
        raise RuntimeError(f"12: the sharded step's leaves {sorted(got)} are not the plain step's")
    return max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30) for k in want)


def _mesh_rank(rank, n, init_file, shape, out):
    """One NCCL rank of phase 12b (spawned, one a card)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}", rank=rank, world_size=n)
    try:
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
        leaves, losses = _mesh_check_run(torch, mesh, torch.device("cuda", rank))
        if rank == 0:
            out.put((leaves, losses))
    finally:
        dist.destroy_process_group()


def phase_meshes(torch, dense, mesh_runs):
    """12: the production meshes; ``dense`` is phase 10a's result, and
    ``mesh_runs`` phase 12c's dry runs from phase 11's worker processes."""
    import gc
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import COLLECTIVES, _line
    from repro_torch.launch.train import make_sharded_train_step, place_params
    from repro_torch.models.transformer import init_params
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import to_device
    from repro_torch.training.optim import AdamW

    t_phase = time.perf_counter()
    res = {}
    n = torch.cuda.device_count()
    log(f"== phase 12a: the production-mesh train step (make_sharded_train_step) on an NCCL process group of "
        f"one rank and a 1 x 1 (data, model) mesh ({n} card(s) on this machine): DTensor replicates everything "
        "on a 1 x 1 mesh, so this checks the DTensor path on the card, not a multi-rank split")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        cfg = get_config(TRAIN_ARCH)
        it = SyntheticLM(cfg.vocab, seed=0).batches(TRAIN_BATCH, TRAIN_SEQ, seed=0)
        batches = [next(it) for _ in range(MESH_TRAIN_STEPS)]
        opt = AdamW(lr=3e-4, total_steps=TRAIN_STEPS, warmup_steps=1)  # phase 10a's schedule
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = place_params(mesh, cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(0)))
        state = opt.init(params)
        times = []
        step = _timed(torch, make_sharded_train_step(cfg, opt, mesh), times)
        counters = _zero_launches()
        losses = []
        for b in batches:
            params, state, loss = step(params, state, to_device(b, "cuda"))
            losses.append(float(loss))
        launches = _no_launches(counters, "12a training")
        peak = torch.cuda.max_memory_allocated()
        ref = dense["losses"][:MESH_TRAIN_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        step_ms = statistics.median(times[1:]) * 1e3
        res["a"] = {"losses": losses, "phase10a_losses": ref, "loss_rel_err": rel, "step_ms": [t * 1e3 for t in times],
                    "median_step_ms": step_ms, "phase10a_median_step_ms": dense["median_step_ms"],
                    "max_memory_allocated": peak, "phase10a_max_memory_allocated": dense["max_memory_allocated"],
                    "launches": launches}
        log(f"  {cfg.name} at full width, {MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
            + ", ".join(f"{l:.4f}" for l in losses) + " (phase 10a: " + ", ".join(f"{l:.4f}" for l in ref)
            + f"), largest relative difference {max(rel):.3e}; median step {step_ms:.2f} ms (steps 2-5; first "
            f"{times[0] * 1e3:.2f} ms) against phase 10a's {dense['median_step_ms']:.2f} ms; peak "
            f"{peak / 2**30:.3f} GiB against {dense['max_memory_allocated'] / 2**30:.3f}; kernel launches {launches}")
        if max(rel) > 1e-3:
            raise RuntimeError(f"12a: the sharded losses {losses} are not within 1e-3 of phase 10a's {ref}")
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        want, plain_losses = _mesh_check_run(torch, None, "cuda")
        got, mesh_losses = _mesh_check_run(torch, mesh, "cuda")
        err = _mesh_check_errors(torch, got, want)
        res["a"]["float32_check"] = {"layers": MESH_CHECK_LAYERS, "steps": MESH_CHECK_STEPS, "worst_leaf_rel_err": err,
                                     "losses": mesh_losses, "plain_losses": plain_losses}
        log(f"  granite-8b at full width cut to {MESH_CHECK_LAYERS} layers, float32, {MESH_CHECK_STEPS} steps of "
            f"{MESH_CHECK_BATCH} x {MESH_CHECK_SEQ}: worst leaf {err:.3e} of its largest |value| against the plain "
            f"step (limit 1e-5); losses {mesh_losses} vs {plain_losses}")
        if err > 1e-5:
            raise RuntimeError(f"12a: a sharded leaf differs from the plain step's by {err:.3e} of its scale")
        del got, want
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    if n >= 2:
        log(f"== phase 12b: one NCCL rank a card, {n} ranks, on a (1, {n}) and a ({n}, 1) mesh")
        want, _ = _mesh_check_run(torch, None, "cuda")
        res["b"] = {}
        ctx = mp.get_context("spawn")
        for shape in ((1, n), (n, 1)):
            with tempfile.TemporaryDirectory() as tmp:
                out = ctx.Queue()
                procs = [ctx.Process(target=_mesh_rank, args=(r, n, f"{tmp}/init", shape, out)) for r in range(n)]
                for p in procs:
                    p.start()
                got, _ = out.get(timeout=600)
                for p in procs:
                    p.join(timeout=60)
                if any(p.exitcode != 0 for p in procs):
                    raise RuntimeError(f"12b: a rank of the {shape} mesh failed: {[p.exitcode for p in procs]}")
            err = _mesh_check_errors(torch, got, want)
            res["b"][f"{shape[0]}x{shape[1]}"] = err
            log(f"  {shape} mesh: worst leaf {err:.3e} of its largest |value| against the plain step (limit 1e-5)")
            if err > 1e-5:
                raise RuntimeError(f"12b: on the {shape} mesh a leaf differs by {err:.3e} of its scale")
    else:
        res["b"] = None
        log(f"== phase 12b did not run: it needs a card a rank and this machine has {n}; the (1, n) and (n, 1) "
            "meshes over several ranks are checked on 4 gloo ranks on the CPU (tests/test_torch_distributed.py)")

    log("== phase 12c: the dry run on the production meshes (run in phase 11's worker processes): per device")
    res["c"] = []
    for status, r in mesh_runs:
        log("  " + _line(status, r))
        if status != "OK":
            raise RuntimeError(f"12c: the dry run of {r['arch']} {r['shape']} on {r['mesh']} failed")
        log(f"    params {r['param_bytes']} + AdamW {r['opt_bytes']} + cache {r['cache_bytes']} + inputs "
            f"{r['input_bytes']} = resident {r['resident_bytes']} bytes (the specs place {r['placement_bytes']}); "
            "collectives " + ", ".join(f"{k} {v}" for k, v in r["collectives"].items()))
        if r["resident_bytes"] != r["placement_bytes"] or set(r["collectives"]) != \
                set(COLLECTIVES.values()) | {"collective-permute"}:
            raise RuntimeError(f"12c: {r['arch']} {r['shape']} on {r['mesh']}: resident {r['resident_bytes']} "
                               f"bytes but the specs place {r['placement_bytes']}")
        res["c"].append(r)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {res['seconds']:.1f} s (12c's dry runs ran in phase 11's table)")
    return res


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

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.launch.serve import make_draft_cfg

    smi = phase_environment(torch)
    rows = phase_kernels(torch)
    # no engine calls the flash-decode kernels (nor does one in the JAX package): phase 2's launches only
    decode_launches = {"decode_attention": decode_attention.launches,
                       "paged_decode_attention": paged_decode_attention.launches}
    main_path, launches = phase_main_path(torch)
    ref_err = phase_reference(torch, make_draft_cfg(get_config("granite-8b")).replace(dtype="float32"), 2)
    # phase 8 (a, c) runs on phase 4's granite models, which are phase 3's (the same seeds), and
    # 8b on phase 7b's recurrentgemma pair, before either is freed
    phase8 = {}

    def granite_phase8(tcfg, tp, dcfg, dp, ctx):
        phase8["a"] = phase_sharded_tree(torch, tcfg, tp, dcfg, dp, ctx)
        phase8["ctx"] = {k: ctx[k] for k in ("prompts", "max_new", "seeds", "tokens")}
        phase8["c"], phase8["c_launches"] = phase_device_verify(torch, tcfg, tp, dcfg, dp, main_path)

    def hybrid_phase8(tcfg, tp, dcfg, dp, ctx):
        phase8["b"] = phase_sharded_replay(torch, tcfg, tp, dcfg, dp, ctx)

    batched = phase_batched(torch, then=granite_phase8)
    # phase 4 has freed its models: the two ranks draw their own copies
    phase8["f"] = phase_rank_shards(torch, phase8["a"], phase8["ctx"])
    batched_ref_err = phase_batched_reference(
        torch, make_draft_cfg(get_config("granite-8b")).replace(dtype="float32"), 3)
    moe, moe_launches = phase_moe(torch)
    moe_draft32 = moe_configs()[1].replace(n_layers=2, dtype="float32")
    moe_ref_err = max(
        phase_reference(torch, moe_draft32, 6, "phase 5b: the MoE draft cut to 2 layers"),
        phase_batched_reference(torch, moe_draft32, 7, "phase 5c: batched passes of the MoE draft cut to 2 layers"))
    nde, nde_single_launches, nde_batched_runs = phase_nde(torch, smi)
    recurrent, rec_single_launches, rec_batched_runs = phase_recurrent(torch, then=hybrid_phase8)
    phase8["d"] = phase_solver_laws(torch)
    phase8["e"], f32_batched_runs, f32_single_launches = phase_float32_match(torch)
    phase8["g"] = phase_data_mesh(torch, phase8.pop("ctx"), batched, phase8["e"]["unsharded_tokens"])
    phase8["seconds"] = sum(phase8[k]["seconds"] for k in "abcdefg")
    log(f"  phase 8 took {phase8['seconds']:.1f} s")
    t9 = time.perf_counter()
    families, family_launches = phase_families(torch)
    family_ref_err, family_ref_launches = phase_family_reference(torch)
    families["seconds"] = time.perf_counter() - t9
    log(f"  phase 9 took {families['seconds']:.1f} s")
    t10 = time.perf_counter()
    training = {"a": phase_train_dense(torch), "b": phase_train_moe(torch), "c": phase_train_reference(torch)}
    training["d"], train_serve_launches = phase_train_then_serve(torch)
    training["seconds"] = time.perf_counter() - t10
    log(f"  phase 10 took {training['seconds']:.1f} s")
    dry_run, dry_run_launches = phase_dry_run(torch)
    meshes = phase_meshes(torch, training["a"], dry_run.pop("mesh_runs"))

    # each kernel's launches over every main-path run (phases 3, 5, 6, 7, 8c, 8e, 9a/9b and 10d single
    # stream, 9c's card passes, both runs of phases 4, 5, 6e, 8a and 8e, 7's, 8b's, 8f's summed over its
    # ranks, 8g's two runs on each rank, phase 11's real
    # decode step; phase 10's and 12's training and phase 11's train step launch none); its times at the
    # hottest shape of its path, in bf16
    runs = [batched["pipelined"]["launches"], batched["sync"]["launches"],
            moe["pipelined"]["launches"], moe["sync"]["launches"], *nde_batched_runs, *rec_batched_runs,
            phase8["a"]["pipelined"]["launches"], phase8["a"]["sync"]["launches"], phase8["b"]["launches"],
            phase8["f"]["launches"], *f32_batched_runs, *phase8["g"]["a"]["launches"], *phase8["g"]["b"]["launches"]]
    total = {name: sum(r[name] for r in runs) for name in runs[0]}
    total["tree_attention"] += (launches + moe_launches + nde_single_launches + rec_single_launches
                                + phase8["c_launches"] + f32_single_launches + family_launches
                                + family_ref_launches + train_serve_launches + dry_run_launches)
    headline = {"tree_attention": "target tree pass", "paged_tree_attention": "paged target tree pass",
                "ragged_paged_tree_attention": "ragged target pass, 8 owners",
                "commit_kv": "36-layer arena, B*P = 32, chains + trash padding",
                "paged_decode_attention": "phase 4 arena, unmapped tails, lengths >= 1, granite-8b heads",
                "decode_attention": "decode_32k, granite-8b heads, window 0, lengths >= 1"}
    replaces = {"tree_attention": "src/repro/kernels/tree_attention.py:189",
                "paged_tree_attention": "src/repro/kernels/tree_attention.py:89",
                "ragged_paged_tree_attention": "src/repro/kernels/tree_attention.py:134",
                "commit_kv": "src/repro/kernels/commit_kv.py:52",
                "paged_decode_attention": "src/repro/kernels/decode_attention.py:76",
                "decode_attention": "src/repro/kernels/decode_attention.py:119"}
    source = {"tree_attention": "tree_attention.cu", "paged_tree_attention": "paged_tree_attention.cu",
              "ragged_paged_tree_attention": "paged_tree_attention.cu", "commit_kv": "commit_kv.cu",
              "paged_decode_attention": "decode_attention.cu", "decode_attention": "decode_attention.cu"}
    entries = []
    for name, case in headline.items():
        row = next(r for r in rows if r["kernel"] == name and r["case"] == case and r["dtype"] == "bfloat16")
        entry = {
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source[name]}",
            "replaces": replaces[name], "launches": total[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "composed_ms": row.get("composed_ms"),
            "at": f"{case}, bf16",
        }
        if name in decode_launches:
            entry["phase2_launches"] = decode_launches[name]
            entry["launches_note"] = ("no engine path calls it, as in the JAX package, whose engines send every "
                                      "masked pass to the tree kernels; launches counts the main-path runs")
        entries.append(entry)
    kernels = {"kernels": entries}
    # the tree kernels' device time per call inside the engines (profiled windows of phases 3-5)
    in_engine = {phase: prof["profile"]["kernel_ms"] for phase, prof in
                 (("phase 3 granite one stream", main_path), ("phase 4 granite 8 streams", batched),
                  ("phase 5 qwen3-moe 8 streams", moe),
                  ("phase 7 recurrentgemma-2b 8 streams", recurrent["recurrentgemma-2b"]),
                  ("phase 9a whisper-medium one stream", families["whisper-medium"]),
                  ("phase 9b internvl2-26b one stream", families["internvl2-26b"]))}
    for phase, rows_ in in_engine.items():
        log(f"  in-engine device time per call, {phase}: " + ", ".join(
            f"{k} {r['us_per_launch']:.2f} us x {r['launches']}" for k, r in rows_.items() if r["launches"]))
    summary = {"main_path": main_path, "draft_card_vs_cpu_rel_err": ref_err, "batched": batched,
               "in_engine_device_time_per_call": in_engine,
               "batched_draft_card_vs_cpu_rel_err": batched_ref_err, "moe": moe,
               "moe_draft_card_vs_cpu_rel_err": moe_ref_err, "nde": nde, "recurrent": recurrent, "phase8": phase8,
               "families": families, "family_drafts_card_vs_cpu_rel_err": family_ref_err, "training": training,
               "dry_run": dry_run, "meshes": meshes,
               "nvidia_smi": smi,
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
