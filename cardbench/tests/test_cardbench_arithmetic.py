"""The metric arithmetic: rates over the whole window, the bound's bytes
and operations, and the useful-FLOP count, each against hand-worked small
cases."""
from types import SimpleNamespace

import pytest
import torch

from harness import bounds, check, spec
from harness.loops import Driver, Record
from harness.stats import rate
from harness.trace import TraceResult, TreeCall
from harness.weights import model_configs
from reference.llama import active_params


def test_rate_is_all_work_over_all_time():
    assert rate(300, 12.0) == 25.0


def _rec(**kw):
    r = Record(w0=0.0, w_end=10.0, w1=10.0)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_readers_on_a_hand_made_record():
    r = _rec(tokens=500, steps=20, counters0={"blocks": 10, "accepted": 0, "pad_nodes_total": 0,
                                              "tree_lanes_total": 0},
             counters1={"blocks": 110, "accepted": 50, "pad_nodes_total": 64, "tree_lanes_total": 256})
    assert spec.metric_reader("output_tok_s")(r) == 50.0
    assert spec.metric_reader("step_ms")(r) == 500.0
    assert spec.metric_reader("block_efficiency")(r) == 1.5
    assert spec.metric_reader("pad_pct")(r) == 25.0
    for m in ("launches_per_step", "mfu_pct", "tree_attn_roofline_pct", "device_idle_pct"):
        assert spec.metric_reader(m)(r) is None  # untraced: nothing to read
    r.trace = TraceResult(window_s=10.0, busy_s=2.5, kernels=4000, by_name={}, gaps=[], tree_kernel_s=0.2,
                          tree_least_s=0.05, tree_calls=10, offset_us=0.0)
    r.flops = 989e12 * 10.0 * 0.02
    assert spec.metric_reader("launches_per_step")(r) == 200.0
    assert spec.metric_reader("device_idle_pct")(r) == 75.0
    assert spec.metric_reader("tree_attn_roofline_pct")(r) == pytest.approx(25.0)
    assert spec.metric_reader("mfu_pct")(r) == pytest.approx(2.0)


def test_blocks_reveal_the_drafts_guesses():
    # depth 4: a block of b tokens matched b - 1 guesses and, under 5, missed the next
    assert check.revealed([3, 5, 1, 2], 11, 4) == ([0, 1, 3, 4, 5, 6, 9], [2, 8, 10])
    # the last block runs past the served tokens: only what was served counts
    assert check.revealed([2, 5], 4, 4) == ([0, 2, 3], [1])
    assert check.revealed([], 3, 4) == ([], [])


def test_draft_gaps_hand_worked():
    # prompt of 2: row 1 predicts served token 0, row 2 served token 1
    ref = torch.tensor([[0.0, 0.0, 0.0], [1.0, 3.0, 2.0], [5.0, 1.0, 4.5]])
    served = [2, 0]
    # a match at 0: best 3.0 - own 2.0; a miss at 1: served token 0 leads 4.5 by 0.5
    assert check.draft_gaps(ref, 2, served, [0], [1]).tolist() == [1.0, 0.5]
    # a match at 1 (the best): 0; a miss at 0 where token 2 does not lead: 0
    assert check.draft_gaps(ref, 2, served, [1], [0]).tolist() == [0.0, 0.0]


def test_rows_bound_hand_worked():
    # one query row of H=2 heads, D=4, S=8 keys, the first 3 admitted, one K/V head, float32
    q = torch.zeros(1, 2, 4)
    mask = torch.zeros(1, 8, dtype=torch.bool)
    mask[0, :3] = True
    ms, by = bounds.rows_bound(torch, q, mask, torch.zeros(1, dtype=torch.long), 1, 1, extra_bytes=8)
    nbytes = 2 * 8 * 4 + 8 + (3 + 3) * 1 * 4 * 4  # q and out, the mask, 3 K rows and 3 V rows
    ops = 2 * 4 * 2 * (3 + 3)  # QK and PV over 3 keys for 2 heads
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / bounds.PEAK_BYTES_PER_S * 1e3)
    assert ops / bounds.PEAK_FLOPS["float32"] < nbytes / bounds.PEAK_BYTES_PER_S
    # a fully masked row reads all of V
    mask2 = torch.zeros(1, 8, dtype=torch.bool)
    ms2, _ = bounds.rows_bound(torch, q, mask2, torch.zeros(1, dtype=torch.long), 1, 1, extra_bytes=8)
    assert ms2 == pytest.approx((2 * 8 * 4 + 8 + 8 * 4 * 4) / bounds.PEAK_BYTES_PER_S * 1e3)


def test_tree_call_least_matches_the_frozen_function():
    B, T, H, D, S = 2, 3, 4, 8, 16
    mask = torch.rand(B, T, S) > 0.5
    call = TreeCall("gqa_paged_tree_attention", (), (B, T, H, D), torch.bfloat16, 2, mask, tbl_numel=6)
    q = torch.zeros(B * T, H, D, dtype=torch.bfloat16)
    ms, _ = bounds.rows_bound(torch, q, mask.reshape(B * T, S), torch.arange(B).repeat_interleave(T), B, 2,
                              mask.numel() + 24)
    assert bounds.tree_call_least_s(call) == pytest.approx(ms / 1e3)
    # a ragged call counts its real lanes only
    owner = torch.tensor([0, 0, 1, -1], dtype=torch.int32)
    m = torch.rand(4, S) > 0.5
    rag = TreeCall("gqa_ragged_tree_attention", (), (4, H, D), torch.bfloat16, 2, m, owner, tbl_numel=6)
    ms_r, _ = bounds.rows_bound(torch, torch.zeros(3, H, D, dtype=torch.bfloat16), m[:3], owner[:3].long(), 2, 2,
                                3 * S + 24 + 16 + 1 * H * D * 2)
    assert bounds.tree_call_least_s(rag) == pytest.approx(ms_r / 1e3)


def test_active_params_of_the_configs():
    g, gd = model_configs(spec.load_cell("granite-8b.chat-closed").config)
    assert active_params(g) == 36 * (2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336) + 4096 * 49152
    assert active_params(gd) == 9 * (2 * 2048 * 2048 + 2 * 2048 * 512 + 3 * 2048 * 7168) + 2048 * 49152


def test_prefill_and_step_flops():
    cfg = spec.load_cell("granite-8b.chat-closed").config
    t, d = model_configs(cfg)
    drv = Driver(SimpleNamespace(), t, d, active_params)
    n = 100
    want = 2 * (active_params(t) + active_params(d)) * n + 4 * (36 * 32 * 128 + 9 * 16 * 128) * n * (n + 1) / 2
    assert drv._prefill_flops(n) == pytest.approx(want)


def test_trace_busy_gaps_and_labels():
    """Busy time is the union of the device records in the window; gaps are
    named by the innermost host span open at their middle; the tree
    kernels' time is taken over the whole trace."""
    from harness.trace import Tracer

    tr = Tracer(eng=None)
    tr.marker_ns = 1_000
    ms = 1_000_000
    tr.spans = [("begin_step", 0, 10 * ms, 1), ("retire_step", 0, 20 * ms, 0), ("verify_step", 30 * ms, 60 * ms, 0)]
    events = [  # (name, start, end) on the device clock, 5 us behind the host's
        ("marker", 6_000, 7_000),
        ("gemm", 2 * ms + 5_000, 6 * ms + 5_000),
        ("copy", 4 * ms + 5_000, 8 * ms + 5_000),  # overlaps the gemm
        ("void paged_attention_kernel<bf16>", 25 * ms + 5_000, 28 * ms + 5_000),
        ("late tree_attention_kernel", 120 * ms, 121 * ms),  # past the window: counted for the kernels only
    ]
    r = tr.result(events, w0_ns=10_000, w1_ns=100 * ms)  # the window opens after the marker
    assert r.busy_s == pytest.approx(0.009)  # 2-8 ms and 25-28 ms
    assert r.kernels == 3
    assert r.tree_kernel_s == pytest.approx(0.004)
    assert r.gaps[0] == ("harness", pytest.approx(0.072))  # 28-100 ms: no span at its middle (64 ms)
    assert r.gaps[1] == ("retire_step", pytest.approx(0.017))  # 8-25 ms: retire_step open at 16.5 ms
    assert r.gaps[2] == ("begin_step", pytest.approx(0.00199))  # 0.01-2 ms: begin_step inside retire_step
