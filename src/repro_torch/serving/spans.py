"""Host spans and counts of the batched engine, kept in memory.

A span is a name, a start and an end on ``time.time_ns`` (the wall clock,
so a device trace aligned to it by one marker lines up with the spans), and
counts.  Spans nest: the log keeps them in the order they opened, so a
span's parent is the last one before it that had not ended.  Two outputs:

  * per-name totals (calls, nanoseconds and each count summed), always
    kept: a span costs two clock reads and a few adds;
  * a log of every span, kept only between ``start_log`` and ``stop_log``.

The batched engine (serving/batch_engine.py) records six phases that never
nest in one another, so per step they add up to the host's time in the
engine: ``admit`` (the scheduling boundary's admissions), ``draft`` (the
draft ingest and the delayed tree's trunk and branch steps), ``target``
(the target's tree pass or replay), ``verify``, ``commit`` and ``retire``.
Inside them: ``prefill`` (one a model an admitted row; ``tokens`` real,
``lanes`` padded), ``draft.ingest``, ``draft.trunk`` and ``draft.branch``
(each draft pass, its readback included), ``verify.row`` (one row's host
walk), ``readback`` (a copy of device results to the host, and the wait
for it: ``bytes`` copied, ``used`` the bytes its caller reads, ``pinned``
the bytes copied into pinned memory) and, in the mesh form, ``exchange``
(one ``all_gather_object`` over the ranks).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

PHASES = ("admit", "draft", "target", "verify", "commit", "retire")


@dataclass
class Span:
    """One logged span."""

    name: str
    start_ns: int
    end_ns: int = 0
    counts: dict = field(default_factory=dict)


class _Open:
    __slots__ = ("spans", "name", "counts", "t0", "logged")

    def __init__(self, spans: "Spans", name: str, counts: dict):
        self.spans, self.name, self.counts = spans, name, counts

    def __enter__(self):
        s = self.spans
        self.t0 = time.time_ns()
        self.logged = None
        if s.log is not None:
            self.logged = Span(self.name, self.t0, counts=self.counts)
            s.log.append(self.logged)
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        s = self.spans
        tot = s._totals.get(self.name)
        if tot is None:
            tot = s._totals[self.name] = {"calls": 0, "ns": 0}
        tot["calls"] += 1
        tot["ns"] += t1 - self.t0
        for key, val in self.counts.items():
            tot[key] = tot.get(key, 0) + val
        if self.logged is not None:
            self.logged.end_ns = t1
        return False


class Spans:
    """The recorder: ``with spans.span(name, **counts): ...``."""

    def __init__(self):
        self._totals: dict[str, dict] = {}
        self.log: list[Span] | None = None

    def span(self, name: str, **counts: int) -> _Open:
        return _Open(self, name, counts)

    def totals(self) -> dict[str, dict]:
        """{name: {"calls", "ns", count: sum, ...}}, a copy."""
        return {name: dict(t) for name, t in self._totals.items()}

    def start_log(self) -> None:
        """Keep every span from now on (a new, empty log)."""
        self.log = []

    def stop_log(self) -> list[Span]:
        """Stop logging and return the log."""
        log, self.log = self.log or [], None
        return log


def sum_totals(parts) -> dict[str, dict]:
    """Several recorders' ``totals()`` summed name by name, key by key."""
    out: dict[str, dict] = {}
    for totals in parts:
        for name, t in totals.items():
            acc = out.setdefault(name, {})
            for key, val in t.items():
                acc[key] = acc.get(key, 0) + val
    return out


def per_step_ms(totals: dict, steps: int, names=PHASES + ("readback",)) -> dict[str, float]:
    """Each name's milliseconds over ``steps`` steps (0 for a name never
    recorded)."""
    return {name: totals.get(name, {}).get("ns", 0) / 1e6 / max(steps, 1) for name in names}


def prefill_pad_pct(totals: dict) -> float | None:
    """100 x the share of the prefills' lanes that were padding (None
    without a prefill)."""
    pre = totals.get("prefill", {})
    return 100 * (pre["lanes"] - pre["tokens"]) / pre["lanes"] if pre.get("lanes") else None


def readback_used_pct(totals: dict) -> float | None:
    """100 x the share of the read-back bytes that their callers read (None
    without a readback)."""
    rb = totals.get("readback", {})
    return 100 * rb["used"] / rb["bytes"] if rb.get("bytes") else None
