"""The batched engine's host spans and counts (serving/spans.py), on the CPU
with tiny float32 models of the port's own (no JAX):

  * every child span lies inside its parent, and the six phases never
    nest in one another or overlap, on both strategies, sync and pipelined;
  * the totals equal the sums over the log;
  * one ``verify.row`` a row a step, each row once a step;
  * ``prefill`` counts each admitted prompt's context and its power-of-two
    padding, once a model;
  * each ``readback``'s ``bytes`` and ``used`` follow from the shapes;
  * the tokens do not depend on the log, and a stopped log stays empty;
  * the sharded engine's totals are its shards' sums and its grouped commits;
  * the readers of scripts/phase_breakdown.py and ``launch/serve.py``'s
    report, on hand-made totals and logs.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # smoke-size ops gain nothing from more; parallel test workers share the cores

from repro_torch.launch.serve import phase_report
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.serving import batch_engine as tbe
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.serve_step import next_pow2
from repro_torch.serving.spans import PHASES, Span, Spans, sum_totals

V = 32
DENSE_T = dict(name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=V,
               dtype="float32")
DENSE_D = dict(name="d", arch_type="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=96, vocab=V,
               dtype="float32")
SSM = dict(name="s", arch_type="ssm", n_layers=2, d_model=48, vocab=V, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
           dtype="float32")
# contexts (prompt minus its last token) of 0, 1, 3, 5 and 9 tokens: padded to 0, 1, 4, 8 and 16 lanes
PROMPTS = [[7], [1, 2], [3, 4, 5, 6], [6, 5, 4, 3, 2, 1], [1, 3, 5, 7, 9, 11, 13, 15, 2, 4]]
SEEDS = [20, 21, 22, 23, 24]
ACTION = (2, 2, 1)  # K, L1, L2


def _pair(tkw, dkw):
    gen = torch.Generator().manual_seed(0)
    tc, dc = ModelConfig(**tkw), ModelConfig(**dkw)
    return tc, init_params(tc, gen), dc, init_params(dc, gen)


@pytest.fixture(scope="module")
def models():
    return {"dense": _pair(DENSE_T, DENSE_D), "ssm": _pair(SSM, SSM)}


def _engine(models, fam="dense", n_slots=3, **kw):
    return tbe.BatchedSpeculativeEngine(*models[fam], EngineConfig("specinfer", *ACTION, max_cache=64),
                                        n_slots=n_slots, block_size=8, **kw)


def _serve(eng, max_new=6):
    rids = [eng.submit(list(p), max_new=max_new, seed=s) for p, s in zip(PROMPTS, SEEDS)]
    out = eng.run()
    return [out[r]["tokens"] for r in rids]


def _parents(log):
    """Each logged span's parent, as an index into ``log`` (None at the
    top): the log holds the spans in the order they opened, so a span's
    parent is the last one before it that had not ended."""
    out, stack = [], []
    for i, sp in enumerate(log):
        while stack and log[stack[-1]].end_ns <= sp.start_ns:
            stack.pop()
        out.append(stack[-1] if stack else None)
        stack.append(i)
    return out


def _logged(models, fam="dense", **kw):
    eng = _engine(models, fam, **kw)
    eng.spans.start_log()
    tokens = _serve(eng)
    return eng, tokens, eng.spans.stop_log()


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_children_nest_and_phases_never_overlap(models, fam, pipeline):
    eng, _, log = _logged(models, fam, pipeline=pipeline)
    names = {sp.name for sp in log}
    assert set(PHASES) | {"prefill", "draft.ingest", "draft.trunk", "draft.branch", "verify.row",
                          "readback"} == names
    par = _parents(log)
    for sp, p in zip(log, par):
        assert sp.start_ns <= sp.end_ns
        if p is not None:
            up = log[p]
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns, (up.name, sp.name)
    # no phase opens inside another, so none overlaps another
    phases = [i for i, sp in enumerate(log) if sp.name in PHASES]
    for i in phases:
        p = par[i]
        while p is not None:
            assert log[p].name not in PHASES, (log[p].name, log[i].name)
            p = par[p]
    assert all(log[a].end_ns <= log[b].start_ns for a, b in zip(phases, phases[1:]))
    # every other span opens inside a phase; the children named for a phase inside it
    assert all(par[i] is not None for i, sp in enumerate(log) if sp.name not in PHASES)
    inside = {"prefill": "admit", "draft.ingest": "draft", "draft.trunk": "draft", "draft.branch": "draft",
              "verify.row": "verify"}
    assert all(log[par[i]].name == inside[sp.name] for i, sp in enumerate(log) if sp.name in inside)
    if pipeline and fam == "dense":  # retire closes around the begun-ahead step: it opens twice a step
        assert eng.span_totals["retire"]["calls"] > eng.span_totals["verify"]["calls"]


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_totals_equal_the_log(models, pipeline):
    eng, _, log = _logged(models, pipeline=pipeline)
    want: dict = {}
    for sp in log:
        t = want.setdefault(sp.name, {"calls": 0, "ns": 0})
        t["calls"] += 1
        t["ns"] += sp.end_ns - sp.start_ns
        for key, val in sp.counts.items():
            t[key] = t.get(key, 0) + val
    assert eng.span_totals == want


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_one_verify_row_per_active_row_per_step(models, pipeline):
    """Step by step: as many ``verify.row`` spans, all in the step's one
    ``verify``, as the step verified blocks (a block is one row's step)."""
    eng = _engine(models, pipeline=pipeline)
    for p, s in zip(PROMPTS, SEEDS):
        eng.submit(list(p), max_new=6, seed=s)
    steps = 0
    while eng.queue or eng.streams:
        blocks = eng.counters["blocks"]
        eng.spans.start_log()
        eng.step()
        log = eng.spans.stop_log()
        par = _parents(log)
        verify = [i for i, sp in enumerate(log) if sp.name == "verify"]
        rows = [par[i] for i, sp in enumerate(log) if sp.name == "verify.row"]
        new = eng.counters["blocks"] - blocks
        assert len(verify) == (1 if new else 0) and rows == verify * new
        assert 0 < new <= eng.n_slots or not new
        steps += 1
    assert steps > 3 and eng.span_totals["verify.row"]["calls"] == eng.counters["blocks"]


@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_prefill_counts_tokens_and_padding(models, fam):
    eng, _, log = _logged(models, fam)
    ctx = [len(p) - 1 for p in PROMPTS]
    lanes = [n if fam == "ssm" or not n else next_pow2(n) for n in ctx]
    t = eng.span_totals["prefill"]
    assert (t["calls"], t["tokens"], t["lanes"]) == (2 * len(PROMPTS), 2 * sum(ctx), 2 * sum(lanes))
    if fam == "dense":
        assert sum(lanes) - sum(ctx) == 0 + 0 + 1 + 3 + 7
    got = sorted((sp.counts["tokens"], sp.counts["lanes"]) for sp in log if sp.name == "prefill")
    assert got == sorted((n, m) for n, m in zip(ctx, lanes) for _ in range(2))


@pytest.mark.parametrize("ragged", [False, "always"], ids=["padded", "ragged"])
def test_readback_bytes_and_used_follow_the_shapes(models, ragged):
    """One synchronous step of three rows: what each readback copies and
    what its caller reads, from the shapes."""
    tc, _, dc, _ = models["dense"]
    eng = _engine(models, pipeline=False, ragged=ragged)
    for p, s in zip(PROMPTS[2:], SEEDS[2:]):
        eng.submit(list(p), max_new=6, seed=s)
    eng.spans.start_log()
    eng.step()
    log = eng.spans.stop_log()
    B, n, (K, L1, L2), f = eng.n_slots, 3, ACTION, 4  # rows, active rows, action, float32 bytes
    Kp, Tpad = next_pow2(K), 1 + next_pow2(L1) + next_pow2(K) * next_pow2(L2)
    nodes = 1 + L1 + K * L2
    Npad = next_pow2(n * nodes)
    want = [("prefill", f * tc.d_model, f * tc.d_model), ("prefill", f * dc.d_model, f * dc.d_model)] * n
    want += [("draft.ingest", f * B * V, f * n * V), ("draft.ingest", f * B * dc.d_model, f * n * dc.d_model)]
    want += [("draft.trunk", f * B * V, f * n * V)] * L1
    want += [("draft.branch", f * B * Kp * V, f * n * K * V)] * L2
    if ragged:
        want += [("verify", f * Npad * V, f * n * nodes * V), ("retire", f * Npad * tc.d_model, f * n * tc.d_model)]
    else:
        want += [("verify", f * B * Tpad * V, f * n * nodes * V),
                 ("retire", f * B * Tpad * tc.d_model, f * n * tc.d_model)]
    par = _parents(log)
    got = [(log[p].name, sp.counts["bytes"], sp.counts["used"]) for sp, p in zip(log, par) if sp.name == "readback"]
    assert got == want
    # on the CPU nothing is copied into pinned memory
    assert all(sp.counts["pinned"] == 0 for sp in log if sp.name == "readback")
    t = eng.span_totals["readback"]
    assert (t["bytes"], t["used"]) == (sum(b for _, b, _ in want), sum(u for _, _, u in want))


def test_log_changes_no_token_and_stays_empty_when_off(models):
    off = _engine(models)
    assert _serve(off) == _logged(models)[1]
    assert off.spans.log is None and off.span_totals["verify"]["calls"] > 0
    eng = _engine(models)
    for p, s in zip(PROMPTS, SEEDS):
        eng.submit(list(p), max_new=6, seed=s)
    eng.spans.start_log()
    eng.step()
    log = eng.spans.stop_log()
    kept, calls = len(log), eng.span_totals["verify"]["calls"]
    eng.run()
    assert len(log) == kept and eng.spans.log is None
    assert eng.span_totals["verify"]["calls"] > calls  # the totals go on


def test_a_span_open_when_the_log_starts_is_left_out():
    spans = Spans()
    with spans.span("retire"):
        spans.start_log()
        with spans.span("readback", bytes=8, used=4, pinned=0):
            pass
    log = spans.stop_log()
    assert [sp.name for sp in log] == ["readback"]
    assert spans.totals() == {"retire": {"calls": 1, "ns": spans.totals()["retire"]["ns"]},
                              "readback": {"calls": 1, "ns": log[0].end_ns - log[0].start_ns,
                                           "bytes": 8, "used": 4, "pinned": 0}}


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_sharded_totals_are_the_shards_sum(models, pipeline):
    eng = tbe.ShardedBatchedSpeculativeEngine(*models["dense"], EngineConfig("specinfer", *ACTION, max_cache=64),
                                              n_slots=4, data_shards=2, block_size=8, pipeline=pipeline)
    _serve(eng)
    own = eng._spans.totals()
    assert eng.span_totals == sum_totals([sh.span_totals for sh in eng.shards] + [own])
    # the grouped commits are the engine's own, each shard's lone commits its own
    assert own["commit"]["calls"] == eng.grouped_commits > 0 and set(own) == {"commit"}
    assert eng.span_totals["commit"]["calls"] == eng.counters["commit_calls"]
    assert all(sh.span_totals["verify"]["calls"] > 0 for sh in eng.shards)


def test_phase_report_reads_ms_a_verified_step():
    totals = {"verify": {"calls": 4, "ns": 8_000_000}, "admit": {"calls": 4, "ns": 4_000_000},
              "prefill": {"calls": 2, "ns": 3_000_000, "tokens": 5, "lanes": 8},
              "readback": {"calls": 3, "ns": 2_000_000, "bytes": 1_000_000, "used": 250_000, "pinned": 0}}
    line = phase_report(totals)
    assert line.startswith("host ms/step (4 verified steps): admit=1.00 draft=0.00 target=0.00 verify=2.00 ")
    assert "readback=0.50 | prefill pad=37.5% readback used=25.0% of 1.0 MB" in line


def _breakdown():
    path = Path(__file__).resolve().parents[1] / "scripts" / "phase_breakdown.py"
    spec = importlib.util.spec_from_file_location("phase_breakdown", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_breakdown_reads_the_window_from_the_totals():
    pb = _breakdown()
    before = {"admit": {"calls": 1, "ns": 1_000_000}, "prefill": {"calls": 2, "ns": 0, "tokens": 9, "lanes": 16}}
    after = {"admit": {"calls": 5, "ns": 9_000_000}, "draft": {"calls": 4, "ns": 20_000_000},
             "target": {"calls": 4, "ns": 6_000_000}, "verify": {"calls": 4, "ns": 12_000_000},
             "verify.row": {"calls": 12, "ns": 10_000_000}, "commit": {"calls": 4, "ns": 400_000},
             "retire": {"calls": 8, "ns": 1_600_000},
             "prefill": {"calls": 6, "ns": 5_000_000, "tokens": 9 + 5 + 63 + 64, "lanes": 16 + 8 + 64 + 64},
             "readback": {"calls": 20, "ns": 7_000_000, "bytes": 4_000_000, "used": 3_000_000, "pinned": 1_000_000}}
    d = pb.delta(after, before)
    assert d["admit"] == {"calls": 4, "ns": 8_000_000} and d["prefill"]["lanes"] == 136
    r = pb.step_readings(d, 4, 50_000_000)
    assert (r["admit_ms"], r["draft_ms"], r["target_ms"], r["verify_host_ms"], r["readback_wait_ms"]) == \
        (2.0, 5.0, 1.5, 2.5, 1.75)
    assert r["prefill_pad_pct"] == pytest.approx(100 * 4 / 136)
    assert r["readback_used_pct"] == 75.0
    # 8 + 20 + 6 + 12 + 0.4 + 1.6 ms of phases in a 50 ms window
    assert r["phases_pct_of_window"] == pytest.approx(96.0)
    empty = pb.step_readings({}, 4, 50_000_000)
    assert empty["prefill_pad_pct"] is None and empty["readback_used_pct"] is None and empty["admit_ms"] == 0


def test_breakdown_labels_idle_gaps_by_the_innermost_span():
    pb = _breakdown()
    log = [Span("verify", 100, 200), Span("readback", 100, 130), Span("verify.row", 130, 160),
           Span("verify.row", 160, 190), Span("commit", 210, 220)]
    pieces = pb.innermost(log)
    assert pieces == [(100, 130, "readback"), (130, 160, "verify.row"), (160, 190, "verify.row"),
                      (190, 200, "verify"), (210, 220, "commit")]
    # device records at 90-120 and 140-150 host ns (an offset of 10), the window 80-230
    gaps = pb.idle_gaps([("k", 100, 130), ("k", 150, 160)], 10, 80, 230)
    assert gaps == [(80, 90), (120, 140), (150, 230)]
    idle = pb.idle_by_span(gaps, pieces)
    assert idle == pytest.approx({"verify.row": 50e-9, "none": 30e-9, "commit": 10e-9, "readback": 10e-9,
                                  "verify": 10e-9})
    assert pb.label_at(175, pieces) == "verify.row" and pb.label_at(205, pieces) is None
    # the closing marker: a float fill, then an in-place float add, found from the end
    fill, add = "elementwise_kernel<4, FillFunctor<float>>", "elementwise_kernel<4, CUDAFunctorOnSelf_add<float>>"
    events = [(fill, 0, 1), (add, 2, 3), ("gemm", 4, 5), (fill, 6, 7), (add, 8, 9), ("gemm", 10, 11)]
    assert pb.marker_at(events) == 3 and pb.marker_at(events[:3]) == 0 and pb.marker_at(events[2:3]) is None
