"""Whether what the window served is right: the served tokens of a sample of
the requests it finished, and the draft's guesses that the engine's blocks
reveal, held to the plain reference of both models.

The traffic decodes greedily.  So each served token is the target's first
choice at its position, and a block of b tokens says that the draft's
greedy chain matched the served tokens at the block's first b - 1
positions and, where b - 1 is under the tree's depth (L1 + L2), missed at
the next.  The reference runs once over each sampled prompt with its served
tokens, the target and the draft alike.

- ``served_gap``: at each served position, how far the served token's
  reference logit lies below the reference target's best.
- ``draft_gap``: at each position a block revealed, how far the draft's
  choice lies below the reference draft's best: at a match, best minus the
  served token's logit; at a miss, the served token's lead over every other
  token, where it leads (the draft chose another token, which lies below
  the best by at least that much).

``*_gap`` is the widest, ``*_gap_mean`` the mean, and ``choice_gap_mean``
the mean over every position of both kinds: every choice of the program
that the check can judge.  A cell's limits file names which it compares.
The control (the reference in fp8) is read the same way at the tokens the
fp8 reference puts first, its draft through the matches those tokens make
at the same positions (``fp8_served_gap``, ``fp8_choice_gap_mean``, ...).
"""
from __future__ import annotations

import numpy as np
import torch

from harness.traffic import stream_rng

CHECK = 5


def sample(finished: list, n: int, seed: int) -> list:
    """The longest of ``finished`` (by served tokens), then up to n - 1
    others drawn from the seed."""
    if not finished:
        return []
    ordered = sorted(finished, key=lambda r: (-len(r.served), r.rid))
    rest = ordered[1:]
    pick = stream_rng(seed, CHECK).permutation(len(rest))[: max(0, n - 1)]
    return [ordered[0]] + [rest[i] for i in sorted(pick)]


def gaps(ref_logits: torch.Tensor, prompt_len: int, served: list, chosen: torch.Tensor | None = None) -> torch.Tensor:
    """Per served position: the reference's best logit minus its logit of
    the served token (or of ``chosen``, a token per position).  Row
    prompt_len - 1 + j of ``ref_logits`` predicts served token j."""
    rows = ref_logits[prompt_len - 1: prompt_len - 1 + len(served)]
    tok = torch.as_tensor(served, device=rows.device) if chosen is None else chosen
    return rows.max(dim=-1).values - rows.gather(1, tok[:, None].long())[:, 0]


def revealed(blocks: list, n: int, depth: int) -> tuple[list, list]:
    """(matched, missed) served positions of the draft's greedy chain, from
    the tokens each block brought (the last may run past the ``n`` served)."""
    matched, missed, pos = [], [], 0
    for b in blocks:
        if pos >= n:
            break
        a = b - 1
        matched.extend(range(pos, min(pos + a, n)))
        if a < depth and pos + a < n:
            missed.append(pos + a)
        pos += b
    return matched, missed


def draft_gaps(ref_logits: torch.Tensor, prompt_len: int, served: list, matched: list,
               missed: list) -> torch.Tensor:
    """The gaps of ``draft_gap`` at ``matched`` + ``missed`` positions."""
    rows = ref_logits[prompt_len - 1: prompt_len - 1 + len(served)]
    tok = torch.as_tensor(served, device=rows.device)[:, None].long()
    own = rows.gather(1, tok)[:, 0]
    out = [rows.max(dim=-1).values[matched] - own[matched]]
    if missed:
        other = rows[missed].scatter(1, tok[missed], float("-inf")).max(dim=-1).values
        out.append((own[missed] - other).clamp_min(0.0))
    return torch.cat(out)


def readings(tp: dict, dp: dict, tcfg: dict, dcfg: dict, family, reqs: list, depth: int,
             controls: tuple = ()) -> dict:
    """Over ``reqs``: ``served_gap``, ``draft_gap``, their means and
    ``choice_gap_mean``, and for each precision in ``controls`` the same
    read at that precision's choices; ``tokens`` served and
    ``draft_positions`` revealed."""
    got = {f"{p}{n}": [] for p in ("", *(f"{c}_" for c in controls)) for n in ("served", "draft")}
    device = tp["embed"].device
    n_pos = n_match = 0
    for r in reqs:
        seq = torch.as_tensor(r.prompt + r.served[:-1], device=device)
        P, n = len(r.prompt), len(r.served)
        matched, missed = revealed(r.blocks, n, depth)
        n_pos, n_match = n_pos + len(matched) + len(missed), n_match + len(matched)
        with torch.no_grad():
            full = family.logits(tp, tcfg, seq)
            got["served"].append(gaps(full, P, r.served))
            for c in controls:
                low = family.logits(tp, tcfg, seq, precision=c)[P - 1:]
                got[f"{c}_served"].append(gaps(full, P, r.served, low.argmax(dim=-1)))
            del full
            full = family.logits(dp, dcfg, seq)
            got["draft"].append(draft_gaps(full, P, r.served, matched, missed))
            for c in controls:
                pick = family.logits(dp, dcfg, seq, precision=c)[P - 1:].argmax(dim=-1).tolist()
                hit = {i for i in matched + missed if pick[i] == r.served[i]}
                got[f"{c}_draft"].append(draft_gaps(full, P, r.served, sorted(hit),
                                                    sorted(set(matched + missed) - hit)))
            del full
    out = {"tokens": sum(len(r.served) for r in reqs), "draft_positions": n_pos, "draft_matched": n_match}
    for name, g in got.items():
        got[name] = g = torch.cat(g) if g else torch.empty(0)
        big = float(g.max()) if g.numel() else float("inf")
        out[f"{name}_gap"], out[f"{name}_gap_mean"] = big, float(g.mean()) if g.numel() else float("inf")
    for p in ("", *(f"{c}_" for c in controls)):
        g = torch.cat([got[f"{p}served"], got[f"{p}draft"]])
        out[f"{p}choice_gap_mean"] = float(g.mean()) if g.numel() else float("inf")
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limited number."""
    shown = {name: {"value": values[name], "limit": lim["limit"]} for name, lim in limits["numbers"].items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
