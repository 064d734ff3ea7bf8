"""Where the engine's host step goes, read from its own spans, in one run of
a cardbench cell.

    python3 scripts/phase_breakdown.py --workload granite-8b.chat-closed \
        --seed <n> --seconds 51 --trace <0|1> --log <0|1> [--out FILE]

from the root of a checkout, on a machine with the cell's CUDA cards.  It
runs the cell as ``cardbench/run.py`` does (the same set-up, window, trace
and check, through ``cardbench/harness``) and adds what the benchmark does
not read yet: the engine's span totals (``span_totals``,
``src/repro_torch/serving/spans.py``) at the window's open and close, and
with ``--log 1`` the engine's span log over the window.  From their
difference it gives ms a step of each phase and pass, the prefill's
padding, the bytes read back and the share of them read, and the six
phases' share of the window; with ``--trace 1`` also the device-idle
seconds under each innermost program span, the ten longest idle gaps
labelled ``<harness span>/<innermost program span>`` (the harness span
alone where no program span was open: the log is off, or the gap fell
between them), and the offset of the device clock to the host's from a
marker at the window's open (the harness's) and one at its close.  The
result is one JSON object, printed last on standard output and appended
to ``--out``.

Temporary: it subclasses the harness's ``Driver`` and ``Tracer`` because
a cardbench metric reader gets the ``Record`` alone, which holds no span
totals.  The ``benchmark`` change that PERF.md section 7 describes (the
totals and the log in ``Record``, the joined gap label and the closing
marker in ``harness/trace.py``, one reader a reading under
``cardbench/metrics/``) replaces it; this script and its tests in
``tests/test_torch_spans.py`` then go.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PASSES = ("prefill", "draft.ingest", "draft.trunk", "draft.branch", "verify.row")


def delta(after: dict, before: dict) -> dict:
    """Span totals over the window: ``after`` minus ``before``, key by key."""
    return {name: {k: v - before.get(name, {}).get(k, 0) for k, v in t.items()} for name, t in after.items()}


def step_readings(d: dict, steps: int, window_ns: int) -> dict:
    """The per-layer readings of a window's span totals ``d`` over ``steps``
    steps and ``window_ns`` of wall time."""
    from repro_torch.serving.spans import PHASES, per_step_ms, prefill_pad_pct, readback_used_pct

    pre, rb = d.get("prefill", {}), d.get("readback", {})
    ms = per_step_ms(d, steps, PHASES + ("readback",) + PASSES)
    return {
        "admit_ms": ms["admit"],
        "prefill_pad_pct": prefill_pad_pct(d),
        "draft_ms": ms["draft"],
        "target_ms": ms["target"],
        "verify_host_ms": ms["verify.row"],
        "readback_wait_ms": ms["readback"],
        "readback_used_pct": readback_used_pct(d),
        "ms_per_step": ms,
        "phases_pct_of_window": 100 * sum(d.get(n, {}).get("ns", 0) for n in PHASES) / window_ns,
        "prefill": pre,
        "readback": rb,
        "readback_mb_per_step": rb.get("bytes", 0) / 1e6 / max(steps, 1),
    }


def idle_gaps(events: list, offset: int, w0: int, w1: int) -> list:
    """The window's intervals (host ns) in which no device record ran, as
    ``harness/trace.py`` finds them."""
    gaps, cur = [], w0
    for _, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s - offset, w0), min(e - offset, w1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def innermost(log: list) -> list:
    """(start, end, name) pieces of time in which ``name`` is the innermost
    open span of ``log`` (spans nest), in order."""
    pieces, stack, cur = [], [], 0
    for sp in sorted(log, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= sp.start_ns:
            end, name = stack.pop()
            pieces.append((cur, end, name))
            cur = end
        if stack:
            pieces.append((cur, sp.start_ns, stack[-1][1]))
        cur = sp.start_ns
        stack.append((sp.end_ns, sp.name))
    while stack:
        end, name = stack.pop()
        pieces.append((cur, end, name))
        cur = end
    return [p for p in pieces if p[1] > p[0]]


def idle_by_span(gaps: list, pieces: list) -> dict:
    """Idle seconds under each innermost program span ("none": under none)."""
    out, j = {}, 0
    for a, b in gaps:
        covered = 0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            ov = min(b, e) - max(a, s)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov / 1e9
                covered += ov
            k += 1
        out["none"] = out.get("none", 0.0) + (b - a - covered) / 1e9
    return dict(sorted(out.items(), key=lambda x: -x[1]))


def marker_at(events: list) -> int | None:
    """Index of the last marker in ``events`` (sorted by start): a float fill
    followed by an in-place float add, as ``torch.ones(1).add_(1)`` runs."""
    for i in range(len(events) - 2, -1, -1):
        if "FillFunctor<float>" in events[i][0] and "CUDAFunctorOnSelf_add<float>" in events[i + 1][0]:
            return i
    return None


def label_at(t: int, pieces: list) -> str | None:
    for s, e, name in pieces:
        if s <= t < e:
            return name
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--log", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    # as cardbench/run.py: one host thread for torch's and numpy's CPU work
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT / "cardbench"), str(ROOT / "src")]

    import torch

    from harness import cell, trace
    from harness.loops import Driver
    from repro_torch.serving.spans import PHASES

    seen = {}

    class SpanDriver(Driver):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen["drv"] = self

        def open_window(self):
            super().open_window()
            self.spans0 = self.eng.span_totals
            if a.log:
                self.eng.spans.start_log()

        def close_window(self):
            super().close_window()
            self.spans1 = self.eng.span_totals
            self.span_log = self.eng.spans.stop_log() if a.log else []

    class MarkedTracer(trace.Tracer):
        def stop(self):
            torch.cuda.synchronize()
            self.marker2_ns = time.time_ns()
            torch.ones(1, device="cuda").add_(1)  # the last device record: the clocks' offset at the close
            events = super().stop()
            seen["tracer"], seen["events"] = self, events
            return events

    cell.Driver, trace.Tracer = SpanDriver, MarkedTracer
    out = cell.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START, root=ROOT)
    drv = seen["drv"]
    rec = drv.rec
    win = rec.w1_ns - rec.w0_ns
    res = {"workload": a.workload, "seed": a.seed, "trace": a.trace, "log": a.log, "correct": out["correct"],
           "card": cell.card_power(), "steps": rec.steps, "window_s": rec.window_s,
           "step_ms": 1e3 * rec.window_s / rec.steps, "output_tok_s": rec.tokens / rec.window_s,
           "setup_s": rec.w0 - T_START, "span_log": len(drv.span_log),
           **step_readings(delta(drv.spans1, drv.spans0), rec.steps, win)}
    if a.trace:
        tr, events = seen["tracer"], seen["events"]
        events.sort(key=lambda e: e[1])
        offset = events[0][1] - tr.marker_ns
        m2 = marker_at(events)
        offset2 = None if m2 is None else events[m2][1] - tr.marker2_ns
        pieces = innermost(drv.span_log)
        gaps = idle_gaps(events, offset, rec.w0_ns, rec.w1_ns)
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for g0, g1 in longest:
            mid = (g0 + g1) // 2
            prog = label_at(mid, pieces)
            named.append([tr._label(mid) + ("/" + prog if prog else ""), (g1 - g0) / 1e9])
        res.update(offsets_us=[offset / 1e3, None if m2 is None else offset2 / 1e3],
                   offset_drift_us=None if m2 is None else (offset2 - offset) / 1e3,
                   records_after_marker=None if m2 is None else len(events) - m2 - 2,
                   idle_s=sum(g1 - g0 for g0, g1 in gaps) / 1e9, idle_by_span=idle_by_span(gaps, pieces),
                   idle_gaps=named, metrics=out["metrics"])
        if drv.span_log:
            in_window = sum(min(sp.end_ns, rec.w1_ns) - max(sp.start_ns, rec.w0_ns) for sp in drv.span_log
                            if sp.name in PHASES
                            and sp.end_ns > rec.w0_ns and sp.start_ns < rec.w1_ns)
            res["phases_pct_of_window_logged"] = 100 * in_window / win
    print(f"phases cover {res['phases_pct_of_window']:.2f} % of the window ({res['step_ms']:.2f} ms a step)",
          file=sys.stderr)
    if a.trace:
        print(f"clock offsets (us) at the open and the close {res['offsets_us']} (drift {res['offset_drift_us']}; "
              f"records after the closing marker: {res['records_after_marker']})", file=sys.stderr)
        for name, s in res["idle_by_span"].items():
            print(f"idle under {name}: {s:.3f} s", file=sys.stderr)
    line = json.dumps(res)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
