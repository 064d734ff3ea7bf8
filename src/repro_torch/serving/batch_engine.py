"""Continuous-batching speculative engine: N concurrent streams per model call.

The counterpart of ``BatchedSpeculativeEngine`` in
src/repro/serving/batch_engine.py, with both target-pass strategies.
Every active stream is packed into lockstep batched calls.  The "tree"
strategy (attention targets) runs per iteration one padded draft-ingest
pass, one draft step per tree level, ONE tree-masked target pass (padded
(B, Tpad), or ragged node-major when that ships fewer lanes) and ONE fused
commit, with per-stream host verification.  The "replay" strategy (SSM and
hybrid targets) scores each stream's trunk in a decode from the committed
snapshot, grouped by exact length, the branches in a forked replay, and
commits by re-advancing the snapshot along the accepted paths, then ONE
scatter of the rows back.  Recurrent state integrates every token it is
given, so recurrent passes of several tokens are grouped by exact length
(the single engine's T) instead of padded to a common one, and one-token
lockstep steps freeze idle rows with ``merge_streams``.  Each stream's tokens are exactly those
of an independent ``SpeculativeEngine`` run with the same seed, as long as
the model's logits do not change with the batch (checked on the CPU in
float32 by tests/test_torch_batch.py; on the card chip_smoke.py reports
it).

The pool is paged by default (models/cache.py): KV lives in a shared arena
of ``block_size``-slot blocks, admission is gated on the free list, dead
tail blocks are reclaimed under pressure, and only then is the most recently
admitted stream evicted.  Scheduling and tokens are those of the JAX engine
for the same seeds (tests/test_torch_batch.py).

Pipelined stepping (``pipeline=True``, the default): ``begin_step`` runs the
scheduling boundary and dispatches the draft and tree-pass work, returning a
``PendingStep`` whose tree outputs are being copied to pinned host memory
behind a CUDA event; ``verify_step`` waits on that event and verifies on the
host; ``commit_step`` issues the fused commit; ``retire_step`` does the
bookkeeping, releases finished streams, begins the NEXT step, and only then
reads the hidden states back.  Scheduling, and therefore tokens, stay those
of the synchronous engine: every release lands before the begun-ahead
boundary, and ``submit`` drains or rewinds a begun step that its request
could have joined.

In-place writes: the model passes write K/V into the pools' arenas in
place.  Trunk drafting writes its speculative KV into the draft arena
(where the JAX engine drafts on a discarded functional copy); those lanes
lie at or past each row's ``len``, keep pos = -1 in the persisted pool and
are rewritten by the next ingest before any mask admits them
(models/cache.py, the frontier invariant).  Recurrent state is never
written in place.  The replay strategy's trunk decodes gathered copies of
its rows, and the branch replay forks a dense copy of the pool's rows, so
the commit re-advances the snapshot as it was, as JAX's ``donate=False``
scatter keeps it; a
pipelined step's recurrent draft pool is rewound from a copied back frame
(``CachePool.begin_frame``).

One pool split over the ranks of a data mesh (``mesh`` a ``DeviceMesh``,
JAX's engine on ``make_data_mesh(n)``): every rank runs the engine's host
program (admission, eviction, buckets, rng, verification) identically over
all ``n_slots`` rows, but holds and passes only its own rows [lo, hi) of the
pool (a paged arena whole, written only through its own rows' tables).
Every per-row readback is an exchange of the ranks' rows (JAX's
``device_get`` of a data-sharded array); a pass over one stream (an
admission's prefill, a selector's peek) runs on the stream's rank and is
broadcast the same way.

``ShardedBatchedSpeculativeEngine`` splits the pool into ``data_shards``
slot shards, each a ``BatchedSpeculativeEngine`` with its own rows and
arena, routed by a bin-packing scheduler.  In one process every shard
lives on the weights' device and the tree strategy commits every verified
shard in one grouped commit; given a process group, each rank serves one
shard from its own card and the ranks exchange only host state, once a
step.  The batched engines verify on the host only: ``verify_on_device``
is refused, as in JAX.
"""
from __future__ import annotations

import functools
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.traversal import delayed_structure
from repro_torch.core.trees import DraftTree
from repro_torch.core.verify import get_verifier
from repro_torch.launch.mesh import data_rows, rank_shard
from repro_torch.launch.sharding import pad_slots, pool_local, pool_shardings
from repro_torch.models.cache import (
    PagedCachePool,
    concat_streams,
    fork_streams,
    gather_streams,
    make_cache_pool,
    scatter_streams,
)
from repro_torch.models.transformer import RECURRENT, forward, init_cache
from repro_torch.sampling import warp_logits
from repro_torch.serving.engine import (
    EngineConfig,
    SamplingParams,
    SpeculativeEngine,
    draw_token,
    to_verifier_dtype,
    verify_tree,
)
from repro_torch.serving.serve_step import (
    StagingBuffers,
    make_group_commit_step,
    make_pool_decode_step,
    make_pool_locked_step,
    make_pool_ragged_tree_step,
    make_pool_tree_step,
    next_pow2 as _next_pow2,
)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _wait(device: torch.device) -> None:
    """Block until the device has run everything queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HostCopy:
    """A device tensor on its way to the host: on a CUDA device a
    non-blocking copy into pinned memory, recorded with an event that
    ``numpy()`` waits on (the JAX engine's ``copy_to_host_async`` future)."""

    def __init__(self, t: torch.Tensor):
        t = t.float()
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _mesh_guarded(method):
    """A public entry point of an engine in the mesh form: an error that
    escapes it on one rank outside any exchange is announced with one
    "failure" exchange, which meets the other ranks' next exchange and makes
    them raise too, so no rank waits on a failed one."""

    @functools.wraps(method)
    def guarded(self, *args, **kwargs):
        if self._rows is None or self._guarded:
            return method(self, *args, **kwargs)
        if self._failed is not None:
            raise RuntimeError(f"the engine failed earlier: {self._failed}")
        self._guarded = True
        try:
            return method(self, *args, **kwargs)
        except BaseException as e:
            if self._failed is None:
                self._failed = f"{type(e).__name__}: {e}"
                got = [None] * self._rows.n
                dist.all_gather_object(got, (self._failed, None), group=self._rows.group)
                self.exchanges["failure"] += 1
            raise
        finally:
            self._guarded = False

    return guarded


@dataclass
class BatchRequest:
    rid: int
    prompt: list
    max_new: int
    seed: int


@dataclass
class PendingStep:
    """A dispatched-but-unverified iteration.  ``p_dev``/``hid_dev`` are the
    warped tree-pass distributions and hidden states on their way to the
    host (tree strategy); the replay strategy's target pass is interleaved
    with the host, so it arrives as ``snapshot`` (the committed target
    pool) and ``p_host`` (per-slot float32 distributions).  ``C0``
    (committed length minus the pending root) and ``D0`` (the attention
    draft pool's pre-ingest length), with the ``rng_state`` snapshots
    (pipelined mode), are the rewind coordinates of ``abort_step``.
    ``roffs`` is ({slot: (offset, n_nodes)}, Npad) for a ragged pass, None
    for the padded (B, Tpad) layout; in the mesh form ``local_offs`` is this
    rank's own packing of its streams' segments, and ``segs`` the exchanged
    tree outputs of every stream ({slot: (p rows, hidden rows)}).
    ``boundary_evicted`` is True when the step's scheduling boundary evicted
    a stream (submit's drain rule)."""

    active: list[int]
    acts: dict[int, tuple]
    pads: tuple[int, int, int, int]
    trees: dict
    hq: dict
    C0: dict[int, int]
    p_dev: HostCopy | None = None
    hid_dev: HostCopy | None = None
    snapshot: dict | None = None
    p_host: dict | None = None
    rng_state: dict | None = None
    D0: dict[int, int] | None = None
    roffs: object = None
    boundary_evicted: bool = False
    local_offs: dict | None = None
    segs: dict | None = None


@dataclass
class VerifiedStep:
    """``verify_step``'s per-stream accept/correction decisions; the
    replay strategy's ``commit_step`` fills ``hid_last``."""

    pending: PendingStep
    accepted: dict[int, list]
    corr: dict[int, int]
    node_paths: dict | None = None
    hid_last: dict | None = None


class BatchedSpeculativeEngine:
    """Multi-stream speculative decoding over a slot-based cache pool.

    API: ``submit(prompt, max_new, seed) -> rid``; ``step()`` advances every
    active stream one speculative block (admitting queued requests first)
    and returns per-request progress; ``run()`` drains the queue and returns
    ``{rid: {"tokens", "reason"}}``.  The weights' device is the engine's
    device.  ``ragged``: True (auto: ragged whenever the flat buffer ships
    fewer lanes than the padded block), ``"always"`` or False.

    ``mesh``: the device this engine's pool lives on (one shard of
    ``ShardedBatchedSpeculativeEngine``, which passes ``shard_id`` too;
    launch/sharding.pool_shardings places the pool).  It must be the
    weights' device: a shard serves from another card as a rank of its
    own (``ShardedBatchedSpeculativeEngine(group=...)``).  Or a
    ``DeviceMesh`` with a ``"data"`` axis (``launch.mesh.make_data_mesh``):
    one pool split over its ranks (module docstring; ``launch.mesh.
    data_rows``), every rank building the engine with the same arguments
    and calling it the same way; the rank's rows live on its weights'
    device, ``launch.mesh.rank_shard``'s, and the mesh's device type says
    where the exchanges run, not where the rows live (``"cpu"``: gloo,
    which also serves ranks sharing one card).  ``exchanges`` counts them by kind: "admit" (the
    prefilled rows' hidden states, once a boundary that admits), "draft"
    (a draft pass's, or a recurrent draft's grouped ingest's, readback),
    "target" (a tree pass's distributions and hidden states together, or
    the replay's trunk and branch groups), "commit" (the replay commit's
    hidden states), "peek" and "failure".  ``idle_passes`` counts by kind
    the passes this rank skipped for holding no row of their group
    ("prefill", "ragged", "replay"); every other pass runs on every rank,
    as JAX's SPMD program does.
    ``profile_commits``: when set, ``commit_ms`` waits
    for the commit to finish on the device instead of timing the host's
    dispatch only (blocking every step would serialize the host against the
    device work the pipeline hides)."""

    def __init__(self, target_cfg, target_params, draft_cfg, draft_params,
                 ecfg: EngineConfig, sampling: SamplingParams | None = None,
                 selector=None, n_slots: int = 4, paged: bool = True,
                 block_size: int = 64, pool_blocks: int | None = None,
                 pipeline: bool = True, mesh=None, shard_id: int = 0, ragged=True):
        if target_cfg.vocab != draft_cfg.vocab:
            raise ValueError(f"target vocab {target_cfg.vocab} != draft vocab {draft_cfg.vocab}")
        if n_slots < 1:
            raise ValueError(f"need at least one pool slot, got {n_slots}")
        if target_cfg.arch_type in ("encdec", "vlm"):
            raise ValueError("batched serving covers decoder-only archs (encdec/vlm prefill kwargs are single-stream)")
        if ecfg.verify_on_device:
            raise ValueError("batched serving verifies per-stream on host (verify_on_device consumes "
                             "randomness differently and would break batch-vs-single exactness)")
        get_verifier(ecfg.verifier)  # fail loudly on unknown names, at build time
        self.tc, self.tp = target_cfg, target_params
        self.dc, self.dp = draft_cfg, draft_params
        self.device = target_params["embed"].device
        if draft_params["embed"].device != self.device:
            raise ValueError(f"target weights on {self.device}, draft weights on "
                             f"{draft_params['embed'].device}")
        self.ecfg = ecfg
        self.sampling = sampling or SamplingParams()
        self.selector = selector
        self.n_slots = n_slots
        self.mesh, self.shard_id = mesh, shard_id
        self.strategy = "replay" if target_cfg.arch_type in RECURRENT else "tree"
        smax = ecfg.max_cache
        page = None
        if paged:
            bs = self.normalize_block_size(smax, block_size)
            self.block_size = bs
            self.max_blocks = smax // bs
            if pool_blocks is None:
                # ring-equivalent capacity: scheduling is then that of the ring pool
                pool_blocks = n_slots * self.max_blocks
            if pool_blocks < 1:
                raise ValueError("the arena needs at least one usable block")
            self.pool_blocks = pool_blocks
            page = (pool_blocks, bs)
        tcache = init_cache(target_cfg, n_slots, smax, self.device, True, page)
        dcache = init_cache(draft_cfg, n_slots, smax, self.device, True, page)
        self._rows, rows = None, None
        self._failed, self._guarded = None, False
        if isinstance(mesh, DeviceMesh):
            self._rows = data_rows(mesh, n_slots)
            _, device = rank_shard(self.device.type, self._rows.group)
            if device != self.device:
                raise ValueError(f"data rank {self._rows.rank} serves its rows from {device}, but its weights "
                                 f"are on {self.device}: draw or move them there")
            tcache, dcache = pool_local(mesh, tcache), pool_local(mesh, dcache)
            rows = (self._rows.lo, self._rows.hi)
            self.exchanges = dict.fromkeys(("admit", "draft", "target", "commit", "peek", "failure"), 0)
            self.idle_passes = dict.fromkeys(("prefill", "ragged", "replay"), 0)
        elif mesh is not None:
            tcache, dcache = pool_shardings(mesh, tcache), pool_shardings(mesh, dcache)
            placed = (tcache["attn"] if "attn" in tcache else tcache)["len"].device
            if placed != self.device:
                raise ValueError(f"the shard's device {placed} is not its weights' device {self.device}: in one "
                                 "process every shard stays on its weights' device; serve a shard from another "
                                 "card as a rank of its own (ShardedBatchedSpeculativeEngine(group=...), "
                                 "launch/serve.py --distributed)")
        self._lo, self._hi = rows if rows is not None else (0, n_slots)
        self.tpool = make_cache_pool(tcache, n_slots, rows)
        self.dpool = make_cache_pool(dcache, n_slots, rows)
        # pure-recurrent caches have no attention component to page
        self.paged = bool(self._paged_pools())
        self.ragged = ragged
        # the JAX "pallas" rule: the ragged pass needs the block-table kernel
        # and the tree strategy.  That kernel takes each node's owner from its
        # own row, so segments pack back to back (the JAX Pallas kernel
        # 8-aligns them instead)
        self._ragged_ok = (bool(ragged) and self.strategy == "tree" and isinstance(self.tpool, PagedCachePool))
        self.streams: dict[int, dict] = {}  # slot -> stream state
        self.queue: list[BatchRequest] = []
        self.finished: dict[int, dict] = {}
        self._next_rid = 0
        self._admit_seq = 0
        self.pipeline = pipeline
        self._staging = StagingBuffers(self.device, banks=2 if pipeline else 1)
        self._pending_next: PendingStep | None = None
        self._drained_events: list[dict] = []
        self.profile_commits = False
        self._steps = {
            "ingest": make_pool_decode_step(draft_cfg),
            "trunk": make_pool_locked_step(draft_cfg),
            "tree": make_pool_tree_step(target_cfg),
            "ragged": make_pool_ragged_tree_step(target_cfg),
        }
        # pipeline_ahead + pipeline_stalls == pipeline_iterations by
        # construction; pad_fraction = pad_nodes_total / tree_lanes_total
        self.counters = {"target_calls": 0, "target_tokens": 0, "draft_calls": 0,
                         "draft_tokens": 0, "accepted": 0, "blocks": 0, "evicted": 0,
                         "commit_calls": 0, "commit_ms": 0.0,  # see profile_commits
                         "blocks_reclaimed": 0, "admit_blocked": 0, "blocks_peak": 0,
                         "pad_nodes_total": 0, "tree_lanes_total": 0,
                         "pipeline_ahead": 0, "pipeline_stalls": 0,
                         "pipeline_iterations": 0, "ragged_calls": 0, "padded_calls": 0}

    # ------------------------------------------------------------- helpers ---

    @staticmethod
    def normalize_block_size(smax: int, block_size: int) -> int:
        """Round the block size down to a power of two, then halve it until
        it divides ``smax``."""
        bs = max(1, min(block_size, smax))
        bs = 1 << (bs.bit_length() - 1)
        while smax % bs:
            bs //= 2
        return bs

    def _stage(self, name, shape, dtype, fill=0):
        return self._staging.get(name, shape, dtype, fill)

    def _up(self, buf: np.ndarray, per: int = 1) -> torch.Tensor:
        """Upload a staged buffer built for all ``n_slots`` rows (``per``
        leading entries a row): this rank's rows only."""
        return self._staging.upload(buf[self._lo * per:self._hi * per])

    def _mine(self, slot: int) -> bool:
        """Whether pool row ``slot`` lives on this rank (always, outside the
        mesh form)."""
        return self.tpool.holds(slot)

    # ------------------------------------------------------ the mesh form ---

    def _exchange(self, kind: str, part) -> list:
        """Run ``part()`` (this rank's share of a readback) and return every
        rank's result in rank order: without a mesh just ``[part()]``; in the
        mesh form ONE ``all_gather_object`` of (error, result) over the data
        axis.  An error ``part`` raises is carried in its slot; if any rank's
        slot holds one, every rank raises after the exchange.  (An error
        outside any exchange is announced by ``_mesh_guarded``.)"""
        if self._rows is None:
            return [part()]
        err, out = None, None
        try:
            out = part()
        except Exception as e:  # re-raised below, after every rank has heard of it
            err = e
        got = [None] * self._rows.n
        dist.all_gather_object(got, (None if err is None else f"{type(err).__name__}: {err}", out),
                               group=self._rows.group)
        self.exchanges[kind] += 1
        failed = [(r, g[0]) for r, g in enumerate(got) if g[0] is not None]
        if failed:
            self._failed = failed[0][1]
            if err is not None:
                raise err
            raise RuntimeError(f"{kind}: rank {failed[0][0]} failed: {failed[0][1]}"
                               + (f" (and {len(failed) - 1} more ranks)" if len(failed) > 1 else ""))
        return [g[1] for g in got]

    def _gathered(self, kind: str, part) -> dict:
        """``_exchange`` of a ``part`` that returns {slot: value} over this
        rank's rows: the union over the ranks."""
        out: dict = {}
        for d in self._exchange(kind, part):
            out.update(d)
        return out

    def _idle(self, kind: str) -> None:
        if self._rows is not None:
            self.idle_passes[kind] += 1

    def _warp(self, logits):
        return warp_logits(logits, self.sampling.temperature, self.sampling.top_p)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64), device=self.device)

    @staticmethod
    def _scatter_rows(pool_cache, trims, rows):
        """Write row-sized sub-caches (``trims``, concatenated along the
        stream axis) into a pool with ONE ``scatter_streams``.  (The JAX
        engine pads the rows, and each grouped recurrent pass, to n_slots so
        that its jitted calls compile once; eager torch has nothing to
        compile and runs the real rows only.)"""
        combined = trims[0] if len(trims) == 1 else concat_streams(trims)
        return scatter_streams(pool_cache, combined, rows)

    # ------------------------------------------------------------ requests ---

    @_mesh_guarded
    def submit(self, prompt: list[int], max_new: int = 64, seed: int | None = None) -> int:
        """Queue a request; it is admitted when a pool row frees up.  ``seed``
        drives this stream's randomness: a single-stream ``SpeculativeEngine``
        with ``EngineConfig(seed=seed)`` emits the same tokens."""
        self.check_prompt(prompt)
        if self._pending_next is not None and self.tpool.free_slots:
            # stall-and-drain: a begun-ahead step locked in admission without
            # this request although a row is free.  If its boundary evicted,
            # the release stands: retire the step (its events surface at the
            # next step()); otherwise rewind it so the next begin_step re-runs
            # the identical boundary with this request queued.
            pending, self._pending_next = self._pending_next, None
            if pending.boundary_evicted:
                self._drained_events.extend(self.finish_step(pending, pipeline_ahead=False))
            else:
                self.abort_step(pending)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(BatchRequest(rid, list(prompt), max_new,
                                       self.ecfg.seed if seed is None else seed))
        return rid

    def check_prompt(self, prompt: list[int]) -> None:
        """Raise if no amount of waiting would admit ``prompt``: it does not
        fit the cache ring, or (paged) its context plus one speculation
        bucket needs more blocks than the arena has."""
        if not 1 <= len(prompt) < self.ecfg.max_cache:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit a {self.ecfg.max_cache}-slot cache ring")
        if self.paged:
            need = self._admit_need(len(prompt))
            cap = min(p.total_blocks for p in self._paged_pools())
            if need > cap:
                raise ValueError(f"prompt of {len(prompt)} tokens needs {need} blocks "
                                 f"(context + one speculation bucket); the arena has {cap}")

    def can_admit(self, prompt_len: int) -> bool:
        """Whether a fresh request of ``prompt_len`` tokens would be admitted
        at the next scheduling boundary without queueing: a free pool row,
        an empty FIFO (admission is strictly in order) and, paged, enough
        free blocks for its context plus one speculation bucket.  Dead-tail
        reclamation is not counted: the sharded scheduler routing on this
        probe must not promise capacity a resident stream's next step could
        take back."""
        if self.queue or not self.tpool.free_slots or not self.dpool.free_slots:
            return False
        if self.paged:
            need = self._admit_need(prompt_len)
            if any(p.free_blocks < need for p in self._paged_pools()):
                return False
        return True

    def _prefill_row(self, cfg, params, ctx):
        """Prefill a fresh 1-row per-stream cache with ``ctx`` tokens: a
        recurrent model at the exact length, an attention model padded to a
        power of two (never past the ring)."""
        row = init_cache(cfg, 1, self.ecfg.max_cache, self.device, per_stream=True)
        if not ctx:
            return row, None
        T = len(ctx)
        if cfg.arch_type in RECURRENT:
            _, row, ex = forward(params, cfg, self._tokens(ctx)[None], mode="full", cache=row)
            return row, _host(ex["hidden"][0, T - 1])
        Tp = min(_next_pow2(T), self.ecfg.max_cache)
        toks = np.zeros((1, Tp), np.int64)
        toks[0, :T] = ctx
        _, row, ex = forward(params, cfg, torch.as_tensor(toks, device=self.device), mode="full",
                             cache=row, lens=torch.tensor([T], dtype=torch.int32, device=self.device))
        return row, _host(ex["hidden"][0, T - 1])

    def _paged_pools(self) -> list[PagedCachePool]:
        return [p for p in (self.tpool, self.dpool) if isinstance(p, PagedCachePool)]

    def _default_tpad(self) -> int:
        return self._bucket_actions({0: (self.ecfg.K, self.ecfg.L1, self.ecfg.L2)})[3]

    def _admit_need(self, prompt_len: int) -> int:
        """Blocks a fresh stream must find free: its context plus one
        default-action speculation bucket."""
        return min(-(-(prompt_len + self._default_tpad()) // self.block_size), self.max_blocks)

    def _admit(self):
        admitted, hidden, hidden_q = [], {}, {}
        while self.queue and self.tpool.free_slots:
            req = self.queue[0]
            if self.paged:
                need = self._admit_need(len(req.prompt))
                short = [p for p in self._paged_pools() if p.free_blocks < need]
                if short:
                    # recycle resident streams' dead tails before leaving the request queued
                    tpad0 = self._default_tpad()
                    keeps = {s: len(st["committed"]) - 1 + tpad0 for s, st in self.streams.items()}
                    for pool in short:
                        self.counters["blocks_reclaimed"] += pool.reclaim_tails(keeps)
                    short = [p for p in self._paged_pools() if p.free_blocks < need]
                if short:
                    if not self.streams:
                        raise RuntimeError(f"request {req.rid} needs {need} free blocks but the empty "
                                           f"pool only has {min(p.free_blocks for p in short)}")
                    self.counters["admit_blocked"] += 1
                    break  # FIFO: the head blocks the queue until blocks free up
            self.queue.pop(0)
            ctx = req.prompt[:-1]
            trow = drow = None
            nxt = self.tpool.next_slot()
            if self._mine(nxt):  # in the mesh form, the row's rank prefills it
                trow, hidden[nxt] = self._prefill_row(self.tc, self.tp, ctx)
                drow, hidden_q[nxt] = self._prefill_row(self.dc, self.dp, ctx)
            else:
                self._idle("prefill")
            slot = self.tpool.admit(trow, ctx_len=len(ctx))
            slot_d = self.dpool.admit(drow, ctx_len=len(ctx))
            if slot != slot_d:
                raise RuntimeError(f"target row {slot} and draft row {slot_d} diverged")
            self._admit_seq += 1
            self.streams[slot] = {
                "rid": req.rid,
                "slot": slot,
                "seq": self._admit_seq,
                "rng": np.random.default_rng(req.seed),
                "max_new": req.max_new,
                "out": [],
                "committed": list(req.prompt),
                "pending": int(req.prompt[-1]),
                "draft_delta": [int(req.prompt[-1])],
                "h_prev_p": None,
                "h_prev_q": None,
                "p_prev": None,
                "q_prev": None,
                "done": False,
            }
            admitted.append(slot)
        if not admitted:
            return
        # the prefilled rows' last hidden states (None for an empty context)
        got = self._gathered("admit", lambda: {s: (hidden[s], hidden_q[s]) for s in admitted if self._mine(s)})
        for s in admitted:
            h_p, h_q = got[s]
            self.streams[s]["h_prev_p"] = h_p if h_p is not None else np.zeros(self.tc.d_model, np.float32)
            self.streams[s]["h_prev_q"] = h_q if h_q is not None else np.zeros(self.dc.d_model, np.float32)

    def _finish(self, slot: int, reason: str = "length"):
        st = self.streams.pop(slot)
        self.finished[st["rid"]] = {"tokens": st["out"][: st["max_new"]], "reason": reason}
        self.tpool.release(slot)
        self.dpool.release(slot)

    def choose_action(self, stream):
        if self.selector is None:
            return self.ecfg.K, self.ecfg.L1, self.ecfg.L2
        return self.selector(stream, self)

    # ------------------------------------------------------------ drafting ---

    def _ingest_deltas(self, active):
        """Advance the draft pool over each stream's newly committed tokens:
        one padded pass, or, for a recurrent draft, one pass per delta
        length over that length's rows and ONE write-back of every row.
        Returns per-slot (q0 dist, draft hidden at the new root)."""
        if self.dc.arch_type in RECURRENT:
            return self._ingest_grouped(active)
        Dp = _next_pow2(max(len(self.streams[s]["draft_delta"]) for s in active))
        toks = self._stage("ing_toks", (self.n_slots, Dp), np.int32)
        lens = self._stage("ing_lens", (self.n_slots,), np.int32)
        for s in active:
            d = self.streams[s]["draft_delta"]
            toks[s, : len(d)] = d
            lens[s] = len(d)

        def part():
            logits, self.dpool.cache, hidden = self._steps["ingest"](
                self.dp, self.dpool.cache, self._up(toks), self._up(lens))
            w, hid = _host(self._warp(logits)), _host(hidden)
            lo = self._lo
            return {s: (w[s - lo, lens[s] - 1], hid[s - lo, lens[s] - 1]) for s in active if self._mine(s)}

        got = self._gathered("draft", part)
        q0 = {s: got[s][0] for s in active}
        hq = {s: got[s][1] for s in active}
        self.counters["draft_calls"] += 1
        self.counters["draft_tokens"] += int(lens.sum())
        return q0, hq

    def _ingest_grouped(self, active):
        groups = defaultdict(list)
        for s in active:
            groups[len(self.streams[s]["draft_delta"])].append(s)
        for L, rows in groups.items():
            self.counters["draft_calls"] += 1
            self.counters["draft_tokens"] += L * len(rows)

        def part():
            out, trims, all_rows = {}, [], []
            for L, rows in sorted(groups.items()):
                rows = [s for s in rows if self._mine(s)]
                if not rows:
                    self._idle("replay")
                    continue
                toks = np.asarray([self.streams[s]["draft_delta"] for s in rows], np.int64)
                sub = gather_streams(self.dpool.cache, [s - self._lo for s in rows])
                logits, sub, ex = forward(self.dp, self.dc, self._tokens(toks), mode="decode", cache=sub)
                trims.append(sub)
                all_rows.extend(s - self._lo for s in rows)
                w = _host(self._warp(logits))
                hid = _host(ex["hidden"])
                for i, s in enumerate(rows):
                    out[s] = (w[i, L - 1], hid[i, L - 1])
            if trims:
                # a held back frame is a copy: the write-back may go into the pool
                self.dpool.cache = self._scatter_rows(self.dpool.cache, trims, all_rows)
            return out

        got = self._gathered("draft", part)
        return {s: got[s][0] for s in active}, {s: got[s][1] for s in active}

    @staticmethod
    def _bucket_actions(acts) -> tuple[int, int, int, int]:
        """Pad the batch's (K, L1, L2) actions to power-of-two buckets:
        (Kp, L1p, L2p, Tpad), the iteration's static shapes."""
        Km = max(a[0] for a in acts.values())
        L1m = max(a[1] for a in acts.values())
        L2m = max(a[2] for a in acts.values())
        L1p = _next_pow2(L1m) if L1m else 0
        L2p = _next_pow2(L2m) if L2m else 0
        Kp = _next_pow2(Km) if (L2p and Km) else 0
        return Kp, L1p, L2p, 1 + L1p + Kp * L2p

    def _frontiers(self, active, Tpad, Dp) -> dict[int, int]:
        """Per-row live slot frontier of this iteration: the tree pass writes
        Tpad slots from C-1 and the padded ingest Dp slots from C-d."""
        out = {}
        for s in active:
            C = len(self.streams[s]["committed"])
            d = len(self.streams[s]["draft_delta"])
            out[s] = max(C - 1 + Tpad, C - d + Dp)
        return out

    def _ensure_pool_blocks(self, active, acts, Tpad, Dp) -> bool:
        """Map the blocks this step's writes need: free-list allocation,
        dead-tail reclamation, then LIFO eviction (re-bucketing after every
        victim).  Mutates ``active``/``acts``; returns True if it evicted."""
        evicted = False
        fr = self._frontiers(active, Tpad, Dp)
        while active:
            short = False
            for pool in self._paged_pools():
                need = sum(pool.missing_blocks(s, fr[s]) for s in active)
                if need > pool.free_blocks:
                    self.counters["blocks_reclaimed"] += pool.reclaim_tails(fr)
                    need = sum(pool.missing_blocks(s, fr[s]) for s in active)
                    if need > pool.free_blocks:
                        short = True
            if not short:
                break
            victim = max(active, key=lambda s: self.streams[s]["seq"])
            self.counters["evicted"] += 1
            self._finish(victim, reason="evicted:pool_blocks")
            active.remove(victim)
            del acts[victim]
            evicted = True
            if active:
                _, _, _, Tpad = self._bucket_actions(acts)
                Dp = _next_pow2(max(len(self.streams[s]["draft_delta"]) for s in active))
                fr = self._frontiers(active, Tpad, Dp)
            else:
                fr = {}
        for pool in self._paged_pools():
            if not pool.ensure_rows(fr):
                raise RuntimeError("free list exhausted after the pressure loop")
        if isinstance(self.tpool, PagedCachePool):
            self.counters["blocks_peak"] = max(self.counters["blocks_peak"], self.tpool.used_blocks)
        return evicted

    def pool_occupancy(self) -> dict:
        """Arena occupancy (blocks used/free, fragmentation) of each paged
        pool; empty for an engine with no paged pool."""
        fr = {s: len(st["committed"]) for s, st in self.streams.items()}
        return {name: pool.occupancy(fr) for name, pool in (("target", self.tpool), ("draft", self.dpool))
                if isinstance(pool, PagedCachePool)}

    def _draft_trees(self, active, acts, q0, pads):
        """Lockstep-draft every stream's (K, L1, L2) delayed tree.  The trunk
        steps write into the draft pool's arena in place but keep its pos and
        len (module docstring), and return a recurrent draft's state as new
        tensors; the branches run on a dense fork."""
        Kp = pads[0]
        L1m = max(a[1] for a in acts.values())
        L2m = max(a[2] for a in acts.values())
        dwork = self.dpool.cache
        cur = dict(q0)
        trunk_tok = {s: [] for s in active}
        trunk_q = {s: [] for s in active}
        for j in range(L1m):
            toks = self._stage(f"trunk_toks{j}", (self.n_slots, 1), np.int32)
            keep = self._stage(f"trunk_keep{j}", (self.n_slots,), np.bool_, fill=False)
            n_live = 0
            for s in active:
                if j < acts[s][1]:
                    t = draw_token(self.streams[s]["rng"], cur[s])
                    toks[s, 0] = t
                    keep[s] = True
                    trunk_tok[s].append(t)
                    n_live += 1

            def trunk_part():
                nonlocal dwork
                logits, dwork = self._steps["trunk"](self.dp, dwork, self._up(toks), self._up(keep))
                w = _host(self._warp(logits[:, 0]))
                return {s: w[s - self._lo] for s in active if keep[s] and self._mine(s)}

            got = self._gathered("draft", trunk_part)
            for s in active:
                if keep[s]:
                    cur[s] = got[s]
                    trunk_q[s].append(got[s])
            self.counters["draft_calls"] += 1
            self.counters["draft_tokens"] += n_live

        branch_tok = {s: [[] for _ in range(acts[s][0])] for s in active}
        branch_q = {s: [[] for _ in range(acts[s][0])] for s in active}
        if Kp and pads[2]:
            dfork = fork_streams(dwork, Kp)
            curb = np.zeros((self.n_slots * Kp, self.tc.vocab), np.float32)
            for s in active:
                for k in range(acts[s][0]):
                    curb[s * Kp + k] = cur[s]
            for j in range(L2m):
                toks = self._stage(f"branch_toks{j}", (self.n_slots * Kp, 1), np.int32)
                n_live = 0
                for s in active:
                    K, _, L2 = acts[s]
                    if j < L2:
                        for k in range(K):
                            t = draw_token(self.streams[s]["rng"], curb[s * Kp + k])
                            toks[s * Kp + k, 0] = t
                            branch_tok[s][k].append(t)
                            n_live += 1

                def branch_part():
                    nonlocal dfork
                    logits, dfork, _ = forward(self.dp, self.dc, self._up(toks, per=Kp), mode="decode", cache=dfork)
                    w = _host(self._warp(logits[:, 0]))
                    return {s * Kp + k: w[(s - self._lo) * Kp + k] for s in active
                            if j < acts[s][2] and self._mine(s) for k in range(acts[s][0])}

                got = self._gathered("draft", branch_part)
                for s in active:
                    K, _, L2 = acts[s]
                    if j < L2:
                        for k in range(K):
                            curb[s * Kp + k] = got[s * Kp + k]
                            branch_q[s][k].append(got[s * Kp + k])
                self.counters["draft_calls"] += 1
                self.counters["draft_tokens"] += n_live

        trees = {}
        for s in active:
            K, L1, L2 = acts[s]
            tokens, parent, depth, pid, qs = [-1], [-1], [0], [0], [q0[s]]
            node = 0
            for j in range(L1):
                tokens.append(trunk_tok[s][j])
                parent.append(node)
                depth.append(depth[node] + 1)
                pid.append(0)
                qs.append(trunk_q[s][j])
                node = len(tokens) - 1
            branch_nodes = [node] * K
            for j in range(L2):
                for k in range(K):
                    tokens.append(branch_tok[s][k][j])
                    parent.append(branch_nodes[k])
                    depth.append(depth[branch_nodes[k]] + 1)
                    pid.append(k)
                    qs.append(branch_q[s][k][j])
                    branch_nodes[k] = len(tokens) - 1
            trees[s] = DraftTree(
                tokens=np.asarray(tokens, np.int64),
                parent=np.asarray(parent, np.int64),
                depth=np.asarray(depth, np.int64),
                q=np.stack(qs),
                path_id=np.asarray(pid, np.int64),
            )
        return trees

    # ----------------------------------------------------------- target -----

    def _target_tree_dispatch(self, active, trees, Tpad):
        """ONE padded tree-masked target pass over every row (idle rows
        frozen); returns its warped distributions and hidden states on their
        way to the host."""
        ttoks = self._stage("tree_toks", (self.n_slots, Tpad), np.int32)
        parents = self._stage("tree_parents", (self.n_slots, Tpad), np.int32, fill=-1)
        keep = self._stage("tree_keep", (self.n_slots,), np.bool_, fill=False)
        for s in active:
            tree = trees[s]
            n = tree.n_nodes
            ttoks[s, :n] = tree.tokens
            ttoks[s, 0] = self.streams[s]["pending"]
            parents[s, :n] = tree.parent
            keep[s] = True
        logits, cache, hidden = self._steps["tree"](self.tp, self.tpool.cache, self._up(ttoks),
                                                    self._up(parents), self._up(keep))
        self.tpool.cache = cache
        real = sum(trees[s].n_nodes for s in active)
        self.counters["target_calls"] += 1
        self.counters["padded_calls"] += 1
        self.counters["target_tokens"] += real
        self.counters["tree_lanes_total"] += self.n_slots * Tpad
        self.counters["pad_nodes_total"] += self.n_slots * Tpad - real
        return HostCopy(self._warp(logits)), HostCopy(hidden)

    def _ragged_layout(self, active, trees):
        """Per-stream (offset, n_nodes) segments, back to back in the flat
        node buffer, and its power-of-two bucketed total Npad."""
        offs, off = {}, 0
        for s in active:
            offs[s] = (off, trees[s].n_nodes)
            off += trees[s].n_nodes
        return offs, _next_pow2(off)

    def _target_tree_dispatch_ragged(self, active, trees, roffs):
        """ONE flat node-major tree pass over every active stream's tree;
        returns its outputs on their way to the host and the packing it ran
        (``roffs``'s segments; in the mesh form each rank packs its own
        streams' segments, and skips the pass when it holds none)."""
        offs, Npad = roffs
        if self._rows is not None:
            mine = [s for s in active if self._mine(s)]
            offs, Npad = self._ragged_layout(mine, trees) if mine else ({}, 0)
        real = sum(trees[s].n_nodes for s in active)
        self.counters["target_calls"] += 1
        self.counters["ragged_calls"] += 1
        self.counters["target_tokens"] += real
        self.counters["tree_lanes_total"] += roffs[1]
        self.counters["pad_nodes_total"] += roffs[1] - real
        if not offs:
            self._idle("ragged")
            return None, None, offs
        toks = self._stage("rtree_toks", (Npad,), np.int32)
        owner = self._stage("rtree_owner", (Npad,), np.int32)
        parent = self._stage("rtree_parent", (Npad,), np.int32, fill=-1)
        depth = self._stage("rtree_depth", (Npad,), np.int32)
        local = self._stage("rtree_local", (Npad,), np.int32, fill=-1)
        counts = self._stage("rtree_counts", (self.n_slots,), np.int32)
        for s, (o, n) in offs.items():
            tree = trees[s]
            toks[o:o + n] = tree.tokens
            toks[o] = self.streams[s]["pending"]
            parent[o:o + n] = np.where(tree.parent >= 0, o + tree.parent, -1)
            depth[o:o + n] = tree.depth
            local[o:o + n] = np.arange(n)
            owner[o:o + n] = s - self._lo
            counts[s] = n
        up = self._staging.upload
        logits, cache, hidden = self._steps["ragged"](
            self.tp, self.tpool.cache, *(up(a) for a in (toks, owner, parent, depth, local)), self._up(counts))
        self.tpool.cache = cache
        return HostCopy(self._warp(logits)), HostCopy(hidden), offs

    def _commit_tables(self, active, node_paths):
        """Stage the fused commit's tables: accepted node paths, path
        lengths, pre-block committed lengths, the active mask, and the
        padded path width P."""
        B = self.n_slots
        P = _next_pow2(max([len(node_paths[s]) for s in active] + [1]))
        npath = self._stage("commit_path", (B, P), np.int32)
        plen = self._stage("commit_plen", (B,), np.int32)
        Cb = self._stage("commit_C", (B,), np.int32)
        act = self._stage("commit_act", (B,), np.bool_, fill=False)
        for s in active:
            path = node_paths[s]
            npath[s, : len(path)] = path
            plen[s] = len(path)
            Cb[s] = len(self.streams[s]["committed"]) - 1
            act[s] = True
        return npath, plen, Cb, act, P

    # --------------------------------------------------- target: replay -----

    def _target_replay(self, active, trees, Kp):
        """Recurrent targets: the trunk decode, grouped by trunk length, from
        the committed snapshot, then the forked branch replay, grouped by
        branch length.  Returns (snapshot, per-slot float32 distributions).
        The target pool itself is not written before the commit.  In the
        mesh form each rank passes its own rows of every group (none: the
        group's pass is skipped) and ONE exchange gathers the
        distributions."""
        snapshot = self.tpool.cache
        structs = {s: delayed_structure(trees[s]) for s in active}
        groups = defaultdict(list)
        for s in active:
            groups[1 + len(structs[s][0])].append(s)
        has_branches = [s for s in active if structs[s][2]]
        bgroups = defaultdict(list)
        if has_branches and Kp:
            for s in has_branches:
                bgroups[len(structs[s][2][0])].append(s)
        for L, rows in groups.items():
            self.counters["target_calls"] += 1
            self.counters["target_tokens"] += L * len(rows)
        for L2, rows in bgroups.items():
            self.counters["target_calls"] += 1
            self.counters["target_tokens"] += L2 * sum(len(structs[s][2]) for s in rows)
        lo = self._lo

        def part():
            p_host = {s: np.zeros((trees[s].n_nodes, trees[s].vocab), np.float32)
                      for s in active if self._mine(s)}
            trims, trunk_rows = [], []
            for L, rows in sorted(groups.items()):
                rows = [s for s in rows if self._mine(s)]
                if not rows:
                    self._idle("replay")
                    continue
                toks = np.zeros((len(rows), L), np.int64)
                for i, s in enumerate(rows):
                    toks[i, 0] = self.streams[s]["pending"]
                    toks[i, 1:] = [int(trees[s].tokens[v]) for v in structs[s][0]]
                sub = gather_streams(snapshot, [s - lo for s in rows])  # a copy: the commit's checkpoint
                logits, sub, _ = forward(self.tp, self.tc, self._tokens(toks), mode="decode", cache=sub)
                trims.append(sub)
                trunk_rows.extend(s - lo for s in rows)
                w = _host(self._warp(logits))
                for i, s in enumerate(rows):
                    p_host[s][0] = w[i, 0]
                    for j, v in enumerate(structs[s][0]):
                        p_host[s][v] = w[i, 1 + j]
            if any(self._mine(s) for rows in bgroups.values() for s in rows):
                # every trunk-advanced row written into a dense copy of the pool's
                # rows (paged rows gathered to their rings), which is forked
                work = gather_streams(snapshot, range(self._hi - lo))
                if trims:
                    work = self._scatter_rows(work, trims, trunk_rows)
                fork = fork_streams(work, Kp)
            for L2, rows in sorted(bgroups.items()):
                rows = [s for s in rows if self._mine(s)]
                if not rows:
                    self._idle("replay")
                    continue
                frows, meta = [], []
                for s in rows:
                    for k, path in enumerate(structs[s][2]):
                        frows.append((s - lo) * Kp + k)
                        meta.append((s, path))
                btoks = np.asarray([[int(trees[s].tokens[v]) for v in path] for s, path in meta], np.int64)
                sub = gather_streams(fork, frows)
                logits, _, _ = forward(self.tp, self.tc, self._tokens(btoks), mode="decode", cache=sub)
                pb = _host(self._warp(logits))
                for i, (s, path) in enumerate(meta):
                    for j, v in enumerate(path):
                        p_host[s][v] = pb[i, j]
            return p_host

        return snapshot, self._gathered("target", part)

    def _commit_replay(self, active, snapshot, accepted_by_slot):
        """Re-advance each stream's row of the snapshot along [root] +
        accepted (grouped by commit length), then write every row back with
        ONE scatter.  Returns each stream's last hidden state (in the mesh
        form each rank re-advances its own rows and ONE exchange gathers
        them)."""
        groups = defaultdict(list)
        for s in active:
            groups[1 + len(accepted_by_slot[s])].append(s)
        lo = self._lo

        def part():
            hid_last, trims, all_rows = {}, [], []
            for L, rows in sorted(groups.items()):
                rows = [s for s in rows if self._mine(s)]
                if not rows:
                    self._idle("replay")
                    continue
                toks = np.zeros((len(rows), L), np.int64)
                for i, s in enumerate(rows):
                    toks[i, 0] = self.streams[s]["pending"]
                    toks[i, 1:] = accepted_by_slot[s]
                sub = gather_streams(snapshot, [s - lo for s in rows])
                _, sub, ex = forward(self.tp, self.tc, self._tokens(toks), mode="decode", cache=sub)
                trims.append(sub)
                all_rows.extend(s - lo for s in rows)
                hid = _host(ex["hidden"])
                for i, s in enumerate(rows):
                    hid_last[s] = hid[i, L - 1]
            t0 = time.perf_counter()
            if trims:
                self.tpool.cache = self._scatter_rows(snapshot, trims, all_rows)
            if self.profile_commits:
                _wait(self.device)
            self.counters["commit_ms"] += (time.perf_counter() - t0) * 1e3
            return hid_last

        hid_last = self._gathered("commit", part)
        self.counters["commit_calls"] += 1
        return hid_last

    # ---------------------------------------------------------------- step ---

    def begin_step(self) -> PendingStep | None:
        """The DISPATCH half of a step: the scheduling boundary (admission,
        capacity eviction, block mapping), then the draft ingest, the
        delayed-tree drafting and the target tree pass.  Returns None when
        nothing is active."""
        self._staging.flip()
        self._admit()
        active = [s for s in sorted(self.streams) if not self.streams[s]["done"]]
        if not active:
            return None
        acts = {s: tuple(self.choose_action(self.streams[s])) for s in active}
        # a stream whose ring cannot hold another padded speculation block or
        # the padded ingest must finish instead of wrapping onto live slots
        _, _, _, Tpad = self._bucket_actions(acts)
        Dp = _next_pow2(max(len(self.streams[s]["draft_delta"]) for s in active))
        smax = self.ecfg.max_cache
        boundary_evicted = False
        for s in list(active):
            C = len(self.streams[s]["committed"])
            d = len(self.streams[s]["draft_delta"])
            if C - 1 + Tpad > smax or C - d + Dp > smax:
                self.counters["evicted"] += 1
                self._finish(s, reason="evicted:cache_full")
                active.remove(s)
                del acts[s]
                boundary_evicted = True
        if not active:
            return None
        pads = self._bucket_actions(acts)
        Tpad = pads[3]
        if self.paged:
            Dp = _next_pow2(max(len(self.streams[s]["draft_delta"]) for s in active))
            if self._ensure_pool_blocks(active, acts, Tpad, Dp):
                boundary_evicted = True
                if not active:
                    return None
                pads = self._bucket_actions(acts)
                Tpad = pads[3]
        C0 = {s: len(self.streams[s]["committed"]) - 1 for s in active}
        rng_state, D0 = None, None
        if self.pipeline:
            rng_state = {s: self.streams[s]["rng"].bit_generator.state for s in active}
            if self.dc.arch_type in RECURRENT:
                # recurrent draft state integrates every token: it rewinds
                # only from a saved copy, the back frame
                self.dpool.begin_frame()
            else:
                # the attention draft rewind is logical: this step's only
                # persisted draft mutation is the append-only delta ingest
                D0 = {s: len(self.streams[s]["committed"]) - len(self.streams[s]["draft_delta"])
                      for s in active}
        q0, hq = self._ingest_deltas(active)
        trees = self._draft_trees(active, acts, q0, pads)
        if self.strategy == "replay":
            snapshot, p_host = self._target_replay(active, trees, pads[0])
            return PendingStep(active=active, acts=acts, pads=pads, trees=trees, hq=hq, C0=C0,
                               snapshot=snapshot, p_host=p_host, rng_state=rng_state, D0=D0,
                               boundary_evicted=boundary_evicted)
        roffs = None
        if self._ragged_ok:
            offs, Npad = self._ragged_layout(active, trees)
            # auto goes ragged only on a strict lane win
            if self.ragged == "always" or Npad < self.n_slots * Tpad:
                roffs = (offs, Npad)
        local_offs = None
        if roffs is not None:
            p_dev, hid_dev, local_offs = self._target_tree_dispatch_ragged(active, trees, roffs)
        else:
            p_dev, hid_dev = self._target_tree_dispatch(active, trees, Tpad)
        return PendingStep(active=active, acts=acts, pads=pads, trees=trees, hq=hq, C0=C0,
                           p_dev=p_dev, hid_dev=hid_dev, rng_state=rng_state, D0=D0, roffs=roffs,
                           boundary_evicted=boundary_evicted, local_offs=local_offs)

    def verify_step(self, pending: PendingStep) -> VerifiedStep:
        """The VERIFY phase: wait for the tree pass's distributions and run
        every stream's host-side accept/reject walk.  Consumes per-stream rng;
        touches no pool or scheduling state (beyond dropping the draft pool's
        back frame: the step is being finished)."""
        if self.dpool.frame_held:
            self.dpool.drop_frame()
        accepted, corr = {}, {}
        if self.strategy == "replay":
            for s in pending.active:
                tree = pending.trees[s]
                tree.p = to_verifier_dtype(pending.p_host[s])
                accepted[s], c = verify_tree(tree, self.ecfg.verifier, self.streams[s]["rng"])
                corr[s] = int(c)
            return VerifiedStep(pending, accepted, corr)
        if self._rows is not None:
            pending.segs = self._tree_segments(pending)
        else:
            p_all = pending.p_dev.numpy()
        node_paths = {}
        for s in pending.active:
            tree = pending.trees[s]
            if pending.segs is not None:
                tree.p = to_verifier_dtype(pending.segs[s][0])
            elif pending.roffs is not None:
                o, n = pending.roffs[0][s]
                tree.p = to_verifier_dtype(p_all[o:o + n])
            else:
                tree.p = to_verifier_dtype(p_all[s, : tree.n_nodes])
            acc, c = verify_tree(tree, self.ecfg.verifier, self.streams[s]["rng"])
            accepted[s], corr[s] = acc, int(c)
            node_paths[s] = SpeculativeEngine._accepted_nodes(tree, acc)
        return VerifiedStep(pending, accepted, corr, node_paths=node_paths)

    def _tree_segments(self, pending: PendingStep) -> dict:
        """The mesh form's readback of a tree pass: ONE exchange of each
        stream's warped distributions and hidden states over its nodes,
        {slot: (p (n, V), hidden (n, d))}."""
        def part():
            if pending.p_dev is None:  # a ragged pass this rank held no node of
                return {}
            p_all, hid_all = pending.p_dev.numpy(), pending.hid_dev.numpy()
            out = {}
            for s in pending.active:
                if not self._mine(s):
                    continue
                n = pending.trees[s].n_nodes
                if pending.local_offs is not None:
                    o = pending.local_offs[s][0]
                    out[s] = (p_all[o:o + n], hid_all[o:o + n])
                else:
                    out[s] = (p_all[s - self._lo, :n], hid_all[s - self._lo, :n])
            return out

        return self._gathered("target", part)

    def commit_step(self, v: VerifiedStep) -> None:
        """The COMMIT phase: ONE fused commit (tree strategy), or the grouped
        replay re-advance and its one write-back (replay strategy, which
        also yields the last hidden states).  Runs before ``retire_step``
        extends ``committed`` (the commit indices are pre-block)."""
        if self.strategy == "tree":
            _commit_trees([self], [v], self.counters)
        else:
            v.hid_last = self._commit_replay(v.pending.active, v.pending.snapshot, v.accepted)

    def _read_hidden(self, v: VerifiedStep) -> None:
        """Publish each stream's last accepted hidden state; departed rows
        (evicted at a begun-ahead boundary) are skipped."""
        pending = v.pending
        if self.strategy == "replay":
            for s in pending.active:
                if s in self.streams:
                    self.streams[s]["h_prev_p"] = v.hid_last[s]
            return
        hid_all = pending.hid_dev.numpy() if pending.segs is None else None
        for s in pending.active:
            if s not in self.streams:
                continue
            path = v.node_paths[s]
            idx = path[-1] if path else 0
            if pending.segs is not None:
                self.streams[s]["h_prev_p"] = pending.segs[s][1][idx]
            elif pending.roffs is not None:
                self.streams[s]["h_prev_p"] = hid_all[pending.roffs[0][s][0] + idx]
            else:
                self.streams[s]["h_prev_p"] = hid_all[s, idx]

    def retire_step(self, v: VerifiedStep, pipeline_ahead: bool | None = None) -> list[dict]:
        """The RETIRE phase: token bookkeeping, release of finished streams,
        the pipeline-ahead decision (begin the next step), then the
        hidden-state readback, deferred past that dispatch when no selector
        reads it at the boundary."""
        pending = v.pending
        retire = [(s, self._advance_stream(s, pending.trees[s], v.accepted[s], v.corr[s], pending.hq[s],
                                           None if v.node_paths is None else v.node_paths[s]))
                  for s in pending.active]
        if pipeline_ahead is None:
            pipeline_ahead = self.pipeline
        # the replay strategy's hid_last is already on the host
        defer_hid = pipeline_ahead and self.strategy == "tree" and self.selector is None
        if not defer_hid:
            self._read_hidden(v)
        for s, ev in retire:
            if ev["done"]:
                self._finish(s)
        if pipeline_ahead:
            if self._pending_next is not None:
                raise RuntimeError("a begun-ahead step is already pending")
            self.counters["pipeline_iterations"] += 1
            self._pending_next = self.begin_step()
            if self._pending_next is not None:
                self.counters["pipeline_ahead"] += 1
            else:
                self.counters["pipeline_stalls"] += 1
        if defer_hid:
            self._read_hidden(v)
        return [ev for _, ev in retire]

    def finish_step(self, pending: PendingStep, pipeline_ahead: bool | None = None) -> list[dict]:
        """Verify + commit + retire a dispatched step."""
        v = self.verify_step(pending)
        self.commit_step(v)
        return self.retire_step(v, pipeline_ahead)

    @_mesh_guarded
    def step(self) -> list[dict]:
        """Admit queued requests, advance every active stream one speculative
        block, and return per-request progress events (in pipelined mode,
        first the step begun ahead, and any events a ``submit`` retired)."""
        events, self._drained_events = self._drained_events, []
        pending, self._pending_next = self._pending_next, None
        if pending is None:
            pending = self.begin_step()
        if pending is None:
            return events
        return events + self.finish_step(pending)

    @_mesh_guarded
    def drain_pipeline(self) -> list[dict]:
        """Finish the begun-ahead step without beginning another."""
        pending, self._pending_next = self._pending_next, None
        if pending is None:
            return []
        return self.finish_step(pending, pipeline_ahead=False)

    def abort_step(self, pending: PendingStep) -> None:
        """Rewind a begun step as if it never dispatched (pipelined mode):
        restore the streams' rng snapshots, rewind the draft pool (a
        recurrent draft from its back frame, an attention draft by erasing
        the ingest, pos >= D0) and erase the target's speculative tree
        lanes (pos >= C0; the replay strategy writes the target pool only
        at its commit).  Boundary decisions (admissions, evictions, block
        mappings) and work counters stand."""
        if pending.rng_state is None:
            raise ValueError("abort_step needs the rng snapshots only pipelined begin_step records")
        if pending is self._pending_next:
            self._pending_next = None
        for s, state in pending.rng_state.items():
            if s in self.streams:
                self.streams[s]["rng"].bit_generator.state = state
        live = [s for s in pending.active if s in self.streams]
        if self.dpool.frame_held:
            self.dpool.rollback_frame()
        elif pending.D0 is not None:
            self.dpool.invalidate_from({s: pending.D0[s] for s in live})
        if self.strategy == "tree":
            self.tpool.invalidate_from({s: pending.C0[s] for s in live})

    @_mesh_guarded
    def abort_pipeline(self) -> int:
        """Rewind the begun-ahead step, if any; returns how many (0 or 1)."""
        pending, self._pending_next = self._pending_next, None
        if pending is None:
            return 0
        self.abort_step(pending)
        return 1

    def _advance_stream(self, slot, tree, accepted, corr, h_q, node_path):
        """Token bookkeeping shared with SpeculativeEngine.step.  Marks the
        stream done at ``max_new`` without releasing its row."""
        st = self.streams[slot]
        if node_path is None:
            node_path = SpeculativeEngine._accepted_nodes(tree, accepted)
        st["p_prev"] = tree.p[node_path[-1]] if accepted else tree.p[0]
        st["q_prev"] = tree.q[node_path[-1]] if accepted else tree.q[0]
        new_tokens = list(accepted) + [corr]
        st["committed"].extend(new_tokens)
        st["pending"] = corr
        st["draft_delta"] = new_tokens
        st["h_prev_q"] = h_q
        st["out"].extend(new_tokens)
        self.counters["accepted"] += len(accepted)
        self.counters["blocks"] += 1
        ev = {"rid": st["rid"], "new_tokens": new_tokens, "done": len(st["out"]) >= st["max_new"]}
        if ev["done"]:
            st["done"] = True
        return ev

    # ------------------------------------------------------ distribution peeks

    def _peek(self, cfg, params, pool, slot: int, toks: list[int]) -> np.ndarray:
        """Score ``toks`` against one pool row WITHOUT mutating the pool:
        gather the row to a dense 1-row cache (new tensors, paged rows come
        back dense), decode on it (the pass writes K/V into that copy only),
        discard it.  The pooled form of the single-stream peek oracles; it
        reads the row as the scheduling boundary leaves it (where selectors
        run: a step begun ahead has already ingested the draft delta).  In
        the mesh form the row's rank peeks and the result is broadcast."""
        def part():
            if not self._mine(slot):
                return {}
            sub = gather_streams(pool.cache, [slot - self._lo])
            tok = torch.as_tensor(np.asarray(toks, np.int64)[None], device=self.device)
            logits, _, _ = forward(params, cfg, tok, mode="decode", cache=sub)
            return {slot: _host(self._warp(logits[0]))[-1]}

        return self._gathered("peek", part)[slot]

    def peek_draft_dist(self, stream, ctx: list[int]) -> np.ndarray:
        """q(. | committed + ctx) for a pooled stream, without mutating it.

        The selector that calls it draws from its OWN rng, shared across the
        streams it serves: its decisions are deterministic per arrival
        order, but not reproduced by independent single-stream runs."""
        toks = list(stream["draft_delta"]) + list(ctx)
        return self._peek(self.dc, self.dp, self.dpool, stream["slot"], toks)

    def peek_target_dist(self, stream, ctx: list[int]) -> np.ndarray:
        """p(. | committed + ctx) for a pooled stream, without mutating it."""
        toks = [stream["pending"]] + list(ctx)
        return self._peek(self.tc, self.tp, self.tpool, stream["slot"], toks)

    # ----------------------------------------------------------------- run ---

    @_mesh_guarded
    def run(self) -> dict[int, dict]:
        """Step until every submitted request finished; returns
        ``{rid: {"tokens", "reason"}}`` for the requests this call completed
        and removes them from the engine."""
        done: dict[int, dict] = {}

        def drain():
            while self.finished:
                rid, info = self.finished.popitem()
                done[rid] = info

        drain()
        while self.queue or self.streams:
            before = len(done)
            self.step()
            drain()
            if not self.streams and not self.queue:
                break
            if not (self.streams or len(done) > before):
                raise RuntimeError("scheduler stalled")
        return done

    def generate_batch(self, prompts, max_new: int = 32, seeds=None) -> list[list[int]]:
        """Submit all prompts, drain, return outputs in order."""
        rids = [self.submit(p, max_new, None if seeds is None else seeds[i]) for i, p in enumerate(prompts)]
        out = self.run()
        return [out[r]["tokens"] for r in rids]


def _commit_trees(engines, verified, counters) -> None:
    """ONE commit call over the accepted paths of each engine's verified
    step (serve_step.make_group_commit_step: one ``commit_kv`` launch an
    engine's pool), counted in ``counters``: an engine's own commit, or a
    sharded engine's grouped commit of its shards.  ``commit_ms`` is the
    host's dispatch, or the device's finish under ``profile_commits``."""
    tables = [eng._commit_tables(v.pending.active, v.node_paths)[:4] for eng, v in zip(engines, verified)]
    t0 = time.perf_counter()
    args = [tuple(eng._up(a) for a in tab) for eng, tab in zip(engines, tables)]
    caches = make_group_commit_step([v.pending.pads[3] for v in verified])(
        tuple(eng.tpool.cache for eng in engines), *zip(*args))
    for eng, cache in zip(engines, caches):
        eng.tpool.cache = cache
    if engines[0].profile_commits:
        _wait(engines[0].device)
    counters["commit_calls"] += 1
    counters["commit_ms"] += (time.perf_counter() - t0) * 1e3


def _take_finished(eng: BatchedSpeculativeEngine) -> dict[int, dict]:
    """Pop a shard's finished payloads ({local rid: payload}, in popitem
    order)."""
    out = {}
    while eng.finished:
        lrid, info = eng.finished.popitem()
        out[lrid] = info
    return out


@dataclass
class ShardRecord:
    """What every rank of a sharded engine with one shard a rank knows of a
    shard: what routing reads (queued requests, live streams, free rows of
    the target and draft pools, free blocks of each paged pool), what a
    ``submit`` to the shard does (a begun-ahead step, whether its boundary
    evicted, the next local rid), and the shard's counters and arena
    occupancy.  Taken from the shard at every exchange; between exchanges
    each rank applies the same ``submitted`` to it."""

    queue: int
    streams: int
    free_rows: tuple[int, int]
    free_blocks: tuple[int, ...]
    pending: bool
    pending_evicted: bool
    next_rid: int
    counters: dict
    occupancy: dict

    @classmethod
    def of(cls, eng: BatchedSpeculativeEngine) -> "ShardRecord":
        p = eng._pending_next
        return cls(len(eng.queue), len(eng.streams), (eng.tpool.free_slots, eng.dpool.free_slots),
                   tuple(pool.free_blocks for pool in eng._paged_pools()), p is not None,
                   p is not None and p.boundary_evicted, eng._next_rid, dict(eng.counters), eng.pool_occupancy())

    def routing(self) -> tuple:
        """The fields a mirror must predict exactly."""
        return (self.queue, self.streams, self.free_rows, self.free_blocks, self.pending, self.pending_evicted,
                self.next_rid)

    def can_admit(self, need: int | None) -> bool:
        """``BatchedSpeculativeEngine.can_admit`` on the recorded state, for a
        request that needs ``need`` free blocks (None: a ring pool)."""
        if self.queue or not all(self.free_rows):
            return False
        return need is None or all(free >= need for free in self.free_blocks)

    def submitted(self) -> bool:
        """Apply a ``submit`` to the shard, as ``BatchedSpeculativeEngine.submit``
        changes it.  False, with nothing applied, when only the owner can
        tell the outcome: the submit finishes a begun-ahead step whose
        boundary evicted (its streams may finish), which the other ranks
        learn by an exchange."""
        if self.pending and self.free_rows[0]:
            if self.pending_evicted:
                return False
            self.pending = False  # rewound: the next step re-runs its boundary
        self.queue += 1
        self.next_rid += 1
        return True


class ShardedBatchedSpeculativeEngine:
    """The continuous-batching pool split into ``data_shards`` slot shards.

    The counterpart of ``ShardedBatchedSpeculativeEngine`` in
    src/repro/serving/batch_engine.py.  Each shard is an independent
    ``BatchedSpeculativeEngine`` over its own rows and (paged) its own
    private block arena: shard-local free lists, block tables, admission
    FIFO, pressure reclamation and eviction.

    The only cross-shard state is the scheduler: ``submit()`` routes each
    request to a shard that can admit it now (``can_admit``), bin-packing on
    the request's expected (K, L1, L2) action first (``_pack_cost``: streams
    of the same speculation bucket land together so each shard's Tpad stays
    tight), least-loaded breaking ties and taking over when no shard can
    admit, deterministically in arrival order.  With homogeneous hints every
    pack cost is 0 and routing is plain least-loaded.  Requests never
    migrate.  A stream's tokens depend only on its seed and its shard's model
    calls, so for the same arrival order the sharded engine emits the
    unsharded engine's tokens as long as the model's logits do not change
    with the batch (tests/test_torch_sharding.py, CPU, float32).

    ``n_slots`` that does not divide ``data_shards`` is padded up
    (``pad_slots``); a total ``pool_blocks`` is split evenly (ceil) so every
    shard's arena gates its own admissions.

    Placement, ``group=None``: every shard lives on the weights' device
    (launch/sharding.pool_shardings), so the tree strategy commits every
    verified shard in ONE grouped commit call (``_commit_shards``).

    ``group``, a process group of exactly ``data_shards`` ranks: one shard a
    rank, JAX's shards on their own devices.  Rank r builds shard r only, on
    its own device (``launch.mesh.rank_shard``: ``cuda:(LOCAL_RANK %
    device_count)``, or the CPU), which must hold its weights; every other
    shard is a ``ShardRecord`` mirror.  Every rank runs ``submit`` and the
    routing on the same arrival sequence, so every rank takes the
    single-process engine's decisions, and only the owner queues the
    request.  A step begins, verifies, commits (alone: a shard a rank never
    groups, as JAX commits shard by shard when the shards are not on one
    device) and retires each rank's own shard, then makes ONE exchange
    (``all_gather_object``) of each shard's events, finished payloads and
    record; no logits, KV or hidden state crosses ranks.  A submit that
    finishes a begun-ahead step whose boundary evicted makes one more.
    ``exchanges`` counts them by kind ("step", "submit", "pipeline").  A
    rank that raises inside an exchanged phase still joins the exchange,
    and every rank then raises.  ``run()``, ``step()``'s events,
    ``finished``, ``counters``, ``pool_occupancy()`` and ``has_work()``
    answer from the exchanged state, the same on every rank; ``queue`` and
    ``streams`` hold this rank's shard only.  The JAX engine's
    ``jit_compile_count`` has no meaning in eager torch and is left out.
    """

    def __init__(self, target_cfg, target_params, draft_cfg, draft_params,
                 ecfg: EngineConfig, sampling: SamplingParams | None = None,
                 selector=None, n_slots: int = 4, data_shards: int = 2,
                 paged: bool = True, block_size: int = 64,
                 pool_blocks: int | None = None, pipeline: bool = True,
                 ragged=True, group=None):
        if data_shards < 1:
            raise ValueError(f"need at least one shard, got {data_shards}")
        self.data_shards = data_shards
        self.n_slots = pad_slots(n_slots, data_shards)
        per_blocks = -(-pool_blocks // data_shards) if paged and pool_blocks is not None else None
        kw = dict(selector=selector, n_slots=self.n_slots // data_shards, paged=paged, block_size=block_size,
                  pool_blocks=per_blocks, pipeline=pipeline, ragged=ragged)
        args = (target_cfg, target_params, draft_cfg, draft_params, ecfg, sampling)
        self.group, self.rank = group, None
        if group is None:
            self.shards = [BatchedSpeculativeEngine(*args, mesh=target_params["embed"].device, shard_id=i, **kw)
                           for i in range(data_shards)]
            self.local = self.shards[0]
        else:
            world = dist.get_world_size(group)
            if world != data_shards:
                raise ValueError(f"one shard a rank: the process group has {world} ranks for {data_shards} shards")
            held = target_params["embed"].device
            self.rank, device = rank_shard(held.type, group)
            if held != device:
                raise ValueError(f"rank {self.rank} serves shard {self.rank} from {device}, but its weights are "
                                 f"on {held}: draw or move them there")
            self.local = BatchedSpeculativeEngine(*args, mesh=device, shard_id=self.rank, **kw)
            self.records = [ShardRecord.of(self.local) for _ in range(data_shards)]
            self.shards = list(self.records)
            self.shards[self.rank] = self.local
            self.exchanges = {"step": 0, "submit": 0, "pipeline": 0}
        s0 = self.local
        self.paged, self.strategy, self.pipeline = s0.paged, s0.strategy, pipeline
        self.ecfg = ecfg
        if s0.paged:
            self.block_size = s0.block_size
            self.pool_blocks = s0.pool_blocks * data_shards
        self.finished: dict[int, dict] = {}
        self._next_rid = 0
        self._local: dict[int, tuple[int, int]] = {}   # global rid -> (shard, local rid)
        self._global: dict[tuple[int, int], int] = {}  # (shard, local rid) -> global rid
        # bin-packing state: global rid -> (shard, expected Tpad) of every live
        # routed request, pruned against _local at submit()
        self._resident: dict[int, tuple[int, int]] = {}
        # engine-level commit counters: a grouped commit belongs to no single
        # shard (the counters property adds them to the shards' sums); a
        # shard a rank never groups, so they stay 0 there
        self._counters = {"commit_calls": 0, "commit_ms": 0.0}

    # --------------------------------------------------------- scheduling ---

    @staticmethod
    def _action_tpad(action) -> int:
        """The speculation bucket (Tpad) a lone stream with this (K, L1, L2)
        action occupies: the bin-packing coordinate, by the engines' own
        bucketing rule."""
        return BatchedSpeculativeEngine._bucket_actions({0: tuple(action)})[3]

    def _pack_cost(self, si: int, tpad: int) -> int:
        """Padding lanes per iteration that joining shard ``si``'s routed
        streams would add: a shard steps at the max of its residents'
        buckets, so joining costs this stream (new_max - tpad) lanes and each
        resident any growth of that max.  0 for an empty shard and whenever
        the buckets match."""
        res = [t for s, t in self._resident.values() if s == si]
        if not res:
            return 0
        cur = max(res)
        new = max(cur, tpad)
        return (new - tpad) + len(res) * (new - cur)

    def _can_admit(self, si: int, prompt_len: int) -> bool:
        if self.group is None:
            return self.shards[si].can_admit(prompt_len)
        return self.records[si].can_admit(self.local._admit_need(prompt_len) if self.paged else None)

    def _load(self, si: int) -> int:
        """Resident + queued requests of shard ``si``."""
        if self.group is not None:
            return self.records[si].streams + self.records[si].queue
        return len(self.shards[si].streams) + len(self.shards[si].queue)

    def _route(self, prompt_len: int, tpad: int) -> int:
        """The shard that can admit now at the least bin-packing cost; load
        (resident + queued, then the lowest shard id) breaks ties, and picks
        among all shards when none can admit (the request queues there)."""
        admitting = [i for i in range(self.data_shards) if self._can_admit(i, prompt_len)]
        pool = admitting or range(self.data_shards)
        return min(pool, key=lambda i: (self._pack_cost(i, tpad), self._load(i), i))

    def shard_of(self, rid: int) -> int:
        """The shard a live (unfinished) request was routed to."""
        return self._local[rid][0]

    def submit(self, prompt: list[int], max_new: int = 64, seed: int | None = None, action_hint=None) -> int:
        """Route to a shard, bin-packing on ``action_hint`` (the request's
        expected (K, L1, L2) action; by default the engine config's, under
        which routing is least-loaded), and queue it there.  Hints steer
        placement only: the selector still decides every step's action.
        With a group every rank must submit the same requests in the same
        order."""
        self._resident = {r: v for r, v in self._resident.items() if r in self._local}
        hint = tuple(action_hint) if action_hint is not None else (self.ecfg.K, self.ecfg.L1, self.ecfg.L2)
        tpad = self._action_tpad(hint)
        if self.group is not None:
            self.local.check_prompt(prompt)  # every rank refuses what the owner would
        si = self._route(len(prompt), tpad)
        if self.group is None:
            lrid = self.shards[si].submit(prompt, max_new=max_new, seed=seed)
        else:
            lrid = self._submit_rank(si, prompt, max_new, seed)
        rid = self._next_rid
        self._next_rid += 1
        self._local[rid] = (si, lrid)
        self._global[(si, lrid)] = rid
        self._resident[rid] = (si, tpad)
        return rid

    def _submit_rank(self, si: int, prompt, max_new, seed) -> int:
        """Queue on shard ``si``'s owner and apply the submit to its record
        on every rank; the owner's next exchange checks the record against
        its shard."""
        lrid = self.records[si].next_rid
        if self.records[si].submitted():
            if si == self.rank:
                self.local.submit(prompt, max_new=max_new, seed=seed)
            return lrid
        _, finished = self._exchange("submit", lambda: self.local.submit(prompt, max_new=max_new, seed=seed)
                                     if si == self.rank else None)
        self._settle(finished)
        return lrid

    def _collect(self, si: int, events: list[dict]) -> list[dict]:
        """Rewrite a shard's events and finished payloads to global rids."""
        out = self._global_events(si, events)
        self._settle({si: _take_finished(self.shards[si])})
        return out

    def _global_events(self, si: int, events: list[dict]) -> list[dict]:
        return [{**ev, "rid": self._global[(si, ev["rid"])]} for ev in events]

    def _settle(self, finished: dict[int, dict]) -> None:
        """Move shards' finished payloads ({shard: {local rid: payload}}) to
        ``finished`` under global rids."""
        for si, payloads in finished.items():
            for lrid, info in payloads.items():
                rid = self._global.pop((si, lrid))
                del self._local[rid]
                self.finished[rid] = info

    # -------------------------------------------------- one shard a rank ---

    def _exchange(self, kind: str, fn):
        """Run ``fn`` on this rank's shard, then ONE ``all_gather_object``
        over the group of (error, ``fn``'s result, finished payloads,
        record).  Returns ([every shard's result], {shard: its finished
        payloads}) with the records updated; the caller rewrites events to
        global rids, then ``_settle``s the payloads.  If any rank raised,
        every rank raises after the exchange, so none waits on a rank that
        failed."""
        sh = self.local
        err, out = None, None
        try:
            if ShardRecord.of(sh).routing() != self.records[self.rank].routing():
                raise RuntimeError(f"shard {self.rank}'s record {self.records[self.rank].routing()} does not "
                                   f"match the shard {ShardRecord.of(sh).routing()}: the ranks' routing diverged")
            out = fn()
        except Exception as e:  # re-raised below, after every rank has heard of it
            err = e
        mine = (None if err is None else f"{type(err).__name__}: {err}", out, _take_finished(sh),
                None if err is not None else ShardRecord.of(sh))
        got = [None] * self.data_shards
        dist.all_gather_object(got, mine, group=self.group)
        self.exchanges[kind] += 1
        if err is not None:
            raise err
        failed = [(r, g[0]) for r, g in enumerate(got) if g[0] is not None]
        if failed:
            raise RuntimeError(f"{kind}: rank {failed[0][0]} failed: {failed[0][1]}"
                               + (f" (and {len(failed) - 1} more ranks)" if len(failed) > 1 else ""))
        for si, g in enumerate(got):
            self.records[si] = g[3]
            if si != self.rank:
                self.shards[si] = g[3]
        return [g[1] for g in got], {si: g[2] for si, g in enumerate(got)}

    def _step_rank(self) -> list[dict]:
        sh = self.local

        def own():
            drained, sh._drained_events = sh._drained_events, []
            pending, sh._pending_next = sh._pending_next, None
            if pending is None:
                pending = sh.begin_step()
            if pending is None:
                return drained, []
            v = sh.verify_step(pending)
            sh.commit_step(v)
            return drained, sh.retire_step(v)

        outs, finished = self._exchange("step", own)
        # the single-process order: every shard's drained events, then each shard's step
        events = [ev for si, (drained, _) in enumerate(outs) for ev in self._global_events(si, drained)]
        events += [ev for si, (_, retired) in enumerate(outs) for ev in self._global_events(si, retired)]
        self._settle(finished)
        return events

    # --------------------------------------------------------------- steps ---

    def _finish_order(self, sis: list[int]) -> list[int]:
        """The order the shards' begun steps are verified in.  Verification
        touches shard-local state only, so any permutation gives the same
        tokens (tests/test_torch_sharding.py shuffles it)."""
        return list(sis)

    def step(self) -> list[dict]:
        """Advance every shard one speculative block: every shard's step is
        begun (dispatched) before any shard's verification waits on the
        device, then the verified shards commit together
        (``_commit_shards``) and retire in shard order; the retire phase
        begins each shard's next step when pipelining.  With a group, each
        rank steps its own shard and the ranks exchange once."""
        if self.group is not None:
            return self._step_rank()
        events = []
        pendings: list = []
        for si, sh in enumerate(self.shards):
            drained, sh._drained_events = sh._drained_events, []
            events.extend(self._collect(si, drained))
            pending, sh._pending_next = sh._pending_next, None
            if pending is None:
                pending = sh.begin_step()
            pendings.append(pending)
        live = [si for si, p in enumerate(pendings) if p is not None]
        verified = {si: self.shards[si].verify_step(pendings[si]) for si in self._finish_order(live)}
        self._commit_shards(verified)
        for si in sorted(verified):
            events.extend(self._collect(si, self.shards[si].retire_step(verified[si])))
        # a shard whose boundary came up empty may still have evicted a stream
        for si in range(self.data_shards):
            if si not in verified:
                events.extend(self._collect(si, []))
        return events

    def _commit_shards(self, verified: dict[int, VerifiedStep]) -> None:
        """Commit every verified shard's accepted paths.  Two or more
        tree-strategy shards commit in ONE grouped call, counted by this
        engine (``_commit_trees``: one ``commit_kv`` launch a shard); a lone
        shard and the replay strategy (whose commit re-advances the snapshot
        on the host's schedule) commit shard by shard."""
        group = sorted(verified)
        if self.strategy != "tree" or len(group) <= 1:
            for si in group:
                self.shards[si].commit_step(verified[si])
            return
        _commit_trees([self.shards[si] for si in group], [verified[si] for si in group], self._counters)

    def drain_pipeline(self) -> list[dict]:
        """Finish every shard's begun-ahead step without beginning another."""
        if self.group is not None:
            outs, finished = self._exchange("pipeline", self.local.drain_pipeline)
            events = [ev for si, evs in enumerate(outs) for ev in self._global_events(si, evs)]
            self._settle(finished)
            return events
        events = []
        for si, sh in enumerate(self.shards):
            events.extend(self._collect(si, sh.drain_pipeline()))
        return events

    def abort_pipeline(self) -> int:
        """Rewind EVERY shard's begun-ahead step (each restores its own rng
        snapshots and pool state); returns how many shards rewound one.  All
        must land, or the next boundary would replay some shards' randomness
        against others' consumed state: with a group, every rank rewinds or
        every rank raises."""
        if self.group is not None:
            outs, finished = self._exchange("pipeline", self.local.abort_pipeline)
            self._settle(finished)
            return sum(outs)
        return sum(sh.abort_pipeline() for sh in self.shards)

    def has_work(self) -> bool:
        """Whether any shard has a queued request or a live stream."""
        if self.group is not None:
            return any(r.queue or r.streams for r in self.records)
        return any(sh.queue or sh.streams for sh in self.shards)

    def _has_streams(self) -> bool:
        if self.group is not None:
            return any(r.streams for r in self.records)
        return any(sh.streams for sh in self.shards)

    def run(self) -> dict[int, dict]:
        """Step until every submitted request finished; returns
        ``{rid: {"tokens", "reason"}}`` (global rids) for the requests this
        call completed."""
        done: dict[int, dict] = {}

        def drain():
            while self.finished:
                rid, info = self.finished.popitem()
                done[rid] = info

        drain()
        while self.has_work():
            before = len(done)
            self.step()
            drain()
            if not self.has_work():
                break
            if not (self._has_streams() or len(done) > before):
                raise RuntimeError("sharded scheduler stalled")
        return done

    def generate_batch(self, prompts, max_new: int = 32, seeds=None) -> list[list[int]]:
        """Submit all prompts, drain, return outputs in order."""
        rids = [self.submit(list(p), max_new, None if seeds is None else seeds[i]) for i, p in enumerate(prompts)]
        out = self.run()
        return [out[r]["tokens"] for r in rids]

    # ------------------------------------------------------------ counters ---

    @property
    def counters(self) -> dict:
        """The shards' counters summed, plus the engine-level grouped-commit
        counters (with a group: every shard's as of the last exchange, the
        same on every rank; ``commit_calls`` is then each shard's own
        commits, and none is grouped).  A read-only view: mutate through
        ``reset_counters`` or the shards' own dicts."""
        out: dict = {}
        per = [r.counters for r in self.records] if self.group is not None else [sh.counters for sh in self.shards]
        for counters in per + [self._counters]:
            for key, val in counters.items():
                out[key] = out.get(key, type(val)()) + val
        return out

    @property
    def grouped_commits(self) -> int:
        """The grouped commit calls (each launched ``commit_kv`` once a shard);
        ``counters["commit_calls"]`` counts them beside the shards' own."""
        return self._counters["commit_calls"]

    def reset_counters(self, keys) -> None:
        """Zero ``keys`` in every shard's counters (with a group, this rank's
        shard's and every record's) and the engine-level ones."""
        per = [sh.counters for sh in self._real()]
        if self.group is not None:
            per += [r.counters for r in self.records]
        for counters in per:
            for key in keys:
                counters[key] = type(counters[key])()
        for key in keys:
            if key in self._counters:
                self._counters[key] = type(self._counters[key])()

    @property
    def profile_commits(self) -> bool:
        return self.local.profile_commits

    @profile_commits.setter
    def profile_commits(self, value: bool) -> None:
        for sh in ([self.local] if self.group is not None else self.shards):
            sh.profile_commits = value

    @property
    def queue(self) -> list:
        """Every shard's queued requests (routing already fixed their shard);
        with a group, this rank's shard's."""
        return [req for sh in self._real() for req in sh.queue]

    @property
    def streams(self) -> dict:
        """(shard, slot) -> stream state over every shard; with a group, over
        this rank's shard."""
        return {(sh.shard_id, s): st for sh in self._real() for s, st in sh.streams.items()}

    def _real(self) -> list[BatchedSpeculativeEngine]:
        return [self.local] if self.group is not None else self.shards

    def pool_occupancy(self) -> dict:
        """Arena occupancy in the unsharded schema, plus ``per_shard``."""
        per = [r.occupancy for r in self.records] if self.group is not None else \
            [sh.pool_occupancy() for sh in self.shards]
        out: dict = {}
        for name in ("target", "draft"):
            shards = [p[name] for p in per if name in p]
            if not shards:
                continue
            used = sum(s["blocks_used"] for s in shards)
            out[name] = {
                "blocks_total": sum(s["blocks_total"] for s in shards),
                "blocks_used": used,
                "blocks_free": sum(s["blocks_free"] for s in shards),
                "block_size": shards[0]["block_size"],
                "fragmentation": (sum(s["fragmentation"] * s["blocks_used"] for s in shards) / used)
                if used else 0.0,
            }
        if out:
            out["per_shard"] = per
        return out
