"""The engine under test, and the loops that drive it through its public API.

The window drives ``BatchedSpeculativeEngine.submit`` and ``.step``; the
harness reads the engine's public ``streams``, ``queue``, ``finished`` and
``counters``.  Every time is the host's ``time.perf_counter()``, taken when
``step()`` returns: that is when a caller gets its tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


def build_engine(tcfg, tp, dcfg, dp, traffic: dict, seed: int):
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig, SamplingParams

    ecfg = EngineConfig(verifier=traffic["verifier"], K=traffic["K"], L1=traffic["L1"], L2=traffic["L2"],
                        max_cache=traffic["max_cache"], seed=int(seed) % (1 << 31))
    return BatchedSpeculativeEngine(
        tcfg, tp, dcfg, dp, ecfg, SamplingParams(traffic["temperature"], traffic["top_p"]),
        n_slots=traffic["rows"], paged=True, block_size=traffic["block_size"], pool_blocks=traffic["pool_blocks"],
        pipeline=traffic["pipeline"], ragged=traffic["ragged"])


@dataclass
class ReqLog:
    rid: int
    prompt: list
    max_new: int
    due: float
    initial: bool
    submitted: float = 0.0
    admitted: float | None = None
    first: float | None = None
    last: float | None = None
    finished: float | None = None
    reason: str | None = None
    n_tokens: int = 0
    served: list = field(default_factory=list)
    blocks: list = field(default_factory=list)  # tokens each of its steps' events brought, in order


@dataclass
class Record:
    """What one run measured; the readers in ``metrics/`` take it."""
    w0: float = 0.0
    w_end: float = 0.0  # the window's nominal close: steps start before it
    w1: float = 0.0  # the return of the window's last step
    w0_ns: int = 0  # the same two instants on the wall clock (``time.time_ns``), for the trace
    w1_ns: int = 0
    steps: int = 0
    tokens: int = 0  # tokens returned to callers by the window's steps
    flops: float = 0.0  # useful model FLOPs of the window's steps
    counters0: dict = field(default_factory=dict)
    counters1: dict = field(default_factory=dict)
    requests: dict = field(default_factory=dict)  # rid -> ReqLog
    trace: object = None  # trace.TraceResult of a traced run

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def delta(self, key: str) -> float:
        return self.counters1[key] - self.counters0[key]

    def due_in_window(self) -> list[ReqLog]:
        return [r for r in self.requests.values() if not r.initial and self.w0 <= r.due < self.w_end]

    def finished_in_window(self) -> list[ReqLog]:
        return [r for r in self.requests.values() if r.finished is not None and self.w0 <= r.finished <= self.w1]


class Driver:
    """Submits requests and steps the engine, logging what callers see.
    ``active_params(cfg)`` is the model family's count (``reference/``)."""

    def __init__(self, eng, tcfg, dcfg, active_params, clock=time.perf_counter):
        self.eng, self.clock = eng, clock
        self.rec = Record()
        self.in_window = False
        self.last_return, self.last_return_ns = 0.0, 0
        # FLOPs a scored token costs (2 x active params) and a key it attends to, per model
        self.per_token = {m: 2 * active_params(c) for m, c in (("target", tcfg), ("draft", dcfg))}
        self.per_key = {m: 4 * c.n_layers * c.n_heads * c.hd for m, c in (("target", tcfg), ("draft", dcfg))}

    def submit(self, req, due: float, initial: bool = False) -> int:
        rid = self.eng.submit(req.prompt, max_new=req.max_new, seed=req.seed)
        now = self.clock()
        self.rec.requests[rid] = ReqLog(rid, req.prompt, req.max_new, due, initial, submitted=now)
        return rid

    def step(self) -> list[int]:
        """One ``step()``; returns the rids that finished in it."""
        eng, rec = self.eng, self.rec
        ctx = [len(st["committed"]) for st in eng.streams.values() if not st["done"]]
        c0 = (eng.counters["target_tokens"], eng.counters["draft_tokens"])
        events = eng.step()
        t = self.last_return = self.clock()
        self.last_return_ns = time.time_ns()
        for ev in events:
            log = rec.requests[ev["rid"]]
            log.blocks.append(len(ev["new_tokens"]))
            take = min(len(ev["new_tokens"]), log.max_new - log.n_tokens)
            if take > 0:
                if log.first is None:
                    log.first = t
                log.n_tokens += take
                log.last = t
                if self.in_window:
                    rec.tokens += take
        for st in eng.streams.values():
            log = rec.requests[st["rid"]]
            if log.admitted is None:
                log.admitted = t
                if self.in_window:
                    rec.flops += self._prefill_flops(len(log.prompt) - 1)
        done = []
        while eng.finished:
            rid, info = eng.finished.popitem()
            log = rec.requests[rid]
            log.finished, log.reason, log.served = t, info["reason"], list(info["tokens"])
            if log.admitted is None:
                log.admitted = t
            done.append(rid)
        if self.in_window:
            rec.steps += 1
            dt = eng.counters["target_tokens"] - c0[0]
            dd = eng.counters["draft_tokens"] - c0[1]
            mean_ctx = sum(ctx) / len(ctx) if ctx else 0.0
            rec.flops += (dt * (self.per_token["target"] + self.per_key["target"] * mean_ctx)
                          + dd * (self.per_token["draft"] + self.per_key["draft"] * mean_ctx))
        return done

    def _prefill_flops(self, n: int) -> float:
        """Both models' prefill of ``n`` real context tokens, each attending
        causally (n (n + 1) / 2 keys)."""
        return sum(self.per_token[m] * n + self.per_key[m] * n * (n + 1) / 2 for m in ("target", "draft"))

    def open_window(self) -> None:
        self.in_window = True
        self.rec.w0, self.rec.w0_ns = self.clock(), time.time_ns()
        self.rec.counters0 = dict(self.eng.counters)

    def close_window(self) -> None:
        self.in_window = False
        if self.last_return >= self.rec.w_end:
            self.rec.w1, self.rec.w1_ns = self.last_return, self.last_return_ns
        else:  # idle at the close
            self.rec.w1, self.rec.w1_ns = self.rec.w_end, self.rec.w0_ns + int((self.rec.w_end - self.rec.w0) * 1e9)
        self.rec.counters1 = dict(self.eng.counters)


def closed_loop(drv: Driver, traffic, spec: dict, seconds: float, before_window=None) -> Record:
    """``initial`` callers, each sending its next request as soon as its last
    one finished (or failed).  Set-up submits the first request of every
    caller (``traffic.initial_request``) and runs ``warmup_steps``."""
    owner, nxt = {}, 0
    for j in range(int(spec["initial"])):
        owner[drv.submit(traffic.initial_request(j), drv.clock(), initial=True)] = j

    def resubmit(done):
        nonlocal nxt
        for rid in done:
            req = traffic.request(nxt)
            nxt += 1
            owner[drv.submit(req, drv.clock())] = owner.pop(rid)

    for _ in range(int(spec["warmup_steps"])):
        resubmit(drv.step())
    if before_window is not None:
        before_window()
    drv.open_window()
    drv.rec.w_end = drv.rec.w0 + seconds
    while drv.clock() < drv.rec.w_end:
        resubmit(drv.step())
    drv.close_window()
    return drv.rec


LOOPS = {"closed": closed_loop}
