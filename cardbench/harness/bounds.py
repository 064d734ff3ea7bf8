"""The least time the card could take for a masked-attention call, and the
H100's peaks: a frozen copy of ``rows_bound`` and ``_bound`` from
chip_smoke.py at the commit that added this benchmark, so that a later
change to that script cannot move the yardstick; ``tree_call_least_s``
applies them to each call as chip_smoke.py's kernel table does
(``attention_bound`` and the paged and ragged rows there).

Peaks: NVIDIA's H100 SXM data sheet (dense, at the 700 W limit).
"""
from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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


# ---------------------------------------------------- the engine's calls ---


def tree_call_least_s(c) -> float:
    """Least seconds of one recorded tree-kernel call (``trace.TreeCall``),
    with the byte and operation counts of chip_smoke.py's kernel table for
    its kind: a dense view (``gqa_tree_attention``), a padded paged pass
    (the mask and block table read once) or a ragged one (real lanes only:
    a padding lane reads nothing and writes zeros)."""
    q = torch.empty(c.q_shape, dtype=c.dtype, device="meta")
    mask = c.mask
    if c.kind != "gqa_ragged_tree_attention":  # a dense view or a padded paged pass (no table: 0 bytes)
        B, T, H, D = c.q_shape
        rows = mask.expand(B, T, mask.shape[-1]).reshape(B * T, -1)
        group = torch.arange(B, device=mask.device).repeat_interleave(T)
        ms, _ = rows_bound(torch, q.reshape(B * T, H, D), rows, group, B, c.hkv, mask.numel() + c.tbl_numel * 4)
    else:
        N, H, D = c.q_shape
        real = c.owner >= 0
        n_real = int(real.sum())
        qr = torch.empty((n_real, H, D), dtype=c.dtype, device="meta")
        n_groups = int(c.owner.max()) + 1 if n_real else 1
        ms, _ = rows_bound(torch, qr, mask[real], c.owner[real].long(), n_groups, c.hkv,
                           mask[real].numel() + c.tbl_numel * 4 + c.owner.numel() * 4
                           + (N - n_real) * H * D * q.element_size())
    return ms / 1e3
