"""A whole run without the look for a card, at a small size on the CPU:
sound, it comes out correct; with the timed path broken underneath, each
fault a serving cell can have makes ``correct`` false: a token altered
where it is produced, a commit that leaves the pool unchanged, half of the
batch verified against another row's distributions, a draft skipped (its
guesses not the draft's) and a draft broken (each row drafting from
another row's distributions).  And the control: the reference in fp8, read
as the check reads a run, fails the cell's limit."""
import time

import numpy as np
import pytest

from harness import spec
from harness.cell import run

CELLS = ["granite-8b.chat-closed"]
SMALL = {
    "granite-8b": {"target": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                                  vocab=16384, dtype="float32"),
                   "draft": dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128, vocab=16384,
                                 dtype="float32"),
                   # two layers instead of 36 and 9: the blocks speak up to count as much
                   "weights": {"block_out_scale": 0.4}},
}


def _run(cell, seed=2**31 + 77, controls=()):
    config = spec.load_cell(cell).config["name"]
    return run(cell, seed, 3.0, False, time.perf_counter(), device="cpu",
               overrides=SMALL[config], controls=controls)


def _alter_token(monkeypatch):
    from repro_torch.serving import batch_engine

    orig = batch_engine.verify_tree

    def altered(tree, verifier, rng):
        acc, corr = orig(tree, verifier, rng)
        return acc, (int(corr) + 1) % len(tree.p[0])

    monkeypatch.setattr(batch_engine, "verify_tree", altered)


def _state_unchanged(monkeypatch):
    """The commit leaves the pool as it was: lengths and positions unmoved."""
    from repro_torch.serving import batch_engine

    monkeypatch.setattr(batch_engine, "_commit_trees", lambda engines, verified, counters: None)


def _half_batch(monkeypatch):
    """Every other stream is verified against the distributions of the
    stream before it: half of the batch's tree-pass outputs left out."""
    from repro_torch.serving import batch_engine

    orig, last = batch_engine.to_verifier_dtype, {}

    def swapped(p):
        last["n"] = last.get("n", 0) + 1
        out = orig(p) if last["n"] % 2 or "p" not in last else last["p"]
        last["p"] = orig(p)
        return out

    monkeypatch.setattr(batch_engine, "to_verifier_dtype", swapped)


def _draft_skipped(monkeypatch):
    """The draft's pass over the committed tokens is read by no one: every
    tree starts from token 0 (its distribution says so, so the verifier
    stays lossless)."""
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine

    orig = BatchedSpeculativeEngine._ingest_deltas

    def skipped(self, active):
        q0, hq = orig(self, active)
        first = np.zeros_like(next(iter(q0.values())))
        first[0] = 1.0
        return {s: first for s in q0}, hq

    monkeypatch.setattr(BatchedSpeculativeEngine, "_ingest_deltas", skipped)


def _draft_broken(monkeypatch):
    """Each row drafts its tree from the next row's first distribution."""
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine

    orig = BatchedSpeculativeEngine._ingest_deltas

    def rotated(self, active):
        q0, hq = orig(self, active)
        rows = sorted(q0)
        return {s: q0[rows[(i + 1) % len(rows)]] for i, s in enumerate(rows)}, hq

    monkeypatch.setattr(BatchedSpeculativeEngine, "_ingest_deltas", rotated)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["check"]
    assert out["_readings"]["tokens"] > 0 and out["metrics"]
    # the blocks reveal guesses of the draft that matched and that missed
    r = out["_readings"]
    assert 0 < r["draft_matched"] < r["draft_positions"]


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged, _half_batch, _draft_skipped, _draft_broken],
                         ids=["token_altered", "state_unchanged", "half_batch", "draft_skipped", "draft_broken"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert out["_readings"]["tokens"] > 0  # something was compared
    assert all(np.isfinite(out["_readings"][n]) for n in spec.load_cell(cell).limits["numbers"])
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails_the_limit(cell):
    out = _run(cell, controls=("fp8",))
    numbers = spec.load_cell(cell).limits["numbers"]
    assert any(out["_readings"]["fp8_" + name] > lim["limit"] for name, lim in numbers.items())
