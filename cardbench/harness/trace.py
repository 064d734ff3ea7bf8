"""The traced run: host spans from the harness, device records from
``torch.profiler`` (the device's activity only: tracing every host op of a
step's thousands of launches would cost more than the step), and the inputs
of every tree-kernel call.

Spans: the engine's public ``begin_step`` / ``verify_step`` /
``commit_step`` / ``retire_step`` / ``submit`` are wrapped on the instance
(``step`` calls them through ``self``), each in a ``record_function`` of its
name, and their host times kept.  An idle gap on the device is named by the
innermost span open at its middle ("harness" outside every span).

Tree-kernel calls: ``gqa_tree_attention``, ``gqa_paged_tree_attention`` and
``gqa_ragged_tree_attention`` as ``models/transformer.py`` binds them are
wrapped; a call keeps references to its mask (and owners), which every pass
builds anew, and nothing runs on the device until the window has closed.
Consecutive calls with the same inputs are the layers of one pass and share
one record.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from harness import bounds

SPANS = ("begin_step", "verify_step", "commit_step", "retire_step", "submit")
TREE_KERNELS = ("tree_attention_kernel", "tree_attention_combine_kernel",
                "paged_attention_kernel", "paged_attention_combine_kernel")
TREE_WRAPPERS = ("gqa_tree_attention", "gqa_paged_tree_attention", "gqa_ragged_tree_attention")


@dataclass
class TreeCall:
    kind: str
    key: tuple
    q_shape: tuple
    dtype: torch.dtype
    hkv: int
    mask: torch.Tensor
    owner: torch.Tensor | None = None
    tbl_numel: int = 0
    calls: int = 1


@dataclass
class TraceResult:
    window_s: float
    busy_s: float
    kernels: int  # kernel records (copies and fills left out)
    by_name: dict  # device op name -> seconds in the window
    gaps: list  # [(label, seconds)], longest first
    tree_kernel_s: float
    tree_least_s: float
    tree_calls: int
    offset_us: float  # marker's device start minus its host launch


@dataclass
class Tracer:
    eng: object
    spans: list = field(default_factory=list)  # (label, t0_ns, t1_ns, depth)
    calls: list = field(default_factory=list)
    _depth: int = 0

    def attach(self) -> None:
        for name in SPANS:
            setattr(self.eng, name, self._span(name, getattr(self.eng, name)))
        from repro_torch.models import transformer

        self._saved = {n: getattr(transformer, n) for n in TREE_WRAPPERS}
        for n in TREE_WRAPPERS:
            setattr(transformer, n, self._recorder(n, self._saved[n]))

    def detach(self) -> None:
        from repro_torch.models import transformer

        for n, fn in self._saved.items():
            setattr(transformer, n, fn)
        for name in SPANS:
            delattr(self.eng, name)

    def _span(self, name, fn):
        def wrapped(*a, **kw):
            self._depth += 1
            t0 = time.time_ns()
            try:
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            finally:
                self._depth -= 1
                self.spans.append((name, t0, time.time_ns(), self._depth))
        return wrapped

    def _recorder(self, kind, fn):
        def wrapped(q, *args):
            mask = args[-1]
            owner = args[-2] if kind == "gqa_ragged_tree_attention" else None
            kv = args[0]
            key = (kind, mask.data_ptr(), tuple(mask.shape), tuple(q.shape),
                   None if owner is None else owner.data_ptr())
            last = self.calls[-1] if self.calls else None
            if last is not None and last.key == key:
                last.calls += 1
            else:
                tbl = args[2] if kind != "gqa_tree_attention" else None
                self.calls.append(TreeCall(kind, key, tuple(q.shape), q.dtype, kv.shape[-2], mask, owner,
                                           0 if tbl is None else tbl.numel()))
            return fn(q, *args)
        return wrapped

    # ----------------------------------------------------------- profiler ---

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.marker_ns = time.time_ns()
        torch.ones(1, device="cuda").add_(1)  # the first device record: aligns the two clocks
        torch.cuda.synchronize()

    def stop(self) -> list:
        torch.cuda.synchronize()
        self.prof.stop()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        del self.prof
        return out

    def result(self, events: list, w0_ns: int, w1_ns: int) -> TraceResult:
        """Device records clipped to the window [w0, w1] (host clock)."""
        events.sort(key=lambda e: e[1])
        offset = events[0][1] - self.marker_ns if events else 0
        # the tree kernels over the whole trace: it holds every recorded call's
        # launches (the engine was idle at its start, and the trace ends with
        # a synchronize), which the window's edges would cut
        tree_s = sum(e - s for name, s, e in events if any(k in name for k in TREE_KERNELS)) / 1e9
        busy, by_name, kernels = 0, {}, 0
        intervals = []
        for name, s, e in events:
            s, e = max(s - offset, w0_ns), min(e - offset, w1_ns)
            if e <= s:
                continue
            intervals.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            kernels += not name.startswith(("Memcpy", "Memset"))
        gaps, cur = [], w0_ns
        for s, e in intervals:  # sorted by start
            if s > cur:
                gaps.append((cur, s))
            busy += max(0, e - max(s, cur))
            cur = max(cur, e)
        if w1_ns > cur:
            gaps.append((cur, w1_ns))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [(self._label((a + b) // 2), (b - a) / 1e9) for a, b in gaps[:10]]
        least = self.tree_least_s()
        return TraceResult(window_s=(w1_ns - w0_ns) / 1e9, busy_s=busy / 1e9, kernels=kernels, by_name=by_name,
                           gaps=named, tree_kernel_s=tree_s, tree_least_s=least,
                           tree_calls=sum(c.calls for c in self.calls), offset_us=offset / 1e3)

    def _label(self, t_ns: int) -> str:
        inner = [(d, name) for name, a, b, d in self.spans if a <= t_ns < b]
        return max(inner)[1] if inner else "harness"

    def tree_least_s(self) -> float:
        """Sum over the recorded calls of the least time the card could take
        (harness/bounds.py), each pass's record times its layers."""
        total = 0.0
        for c in self.calls:
            total += c.calls * bounds.tree_call_least_s(c)
        return total
