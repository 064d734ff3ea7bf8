"""The training loop: the counterpart of src/repro/training/loop.py.

``train`` draws the parameters with the port's ``init_params`` from a
seeded ``torch.Generator`` on ``device`` (unless given), moves each numpy
batch there, runs ``make_train_step`` (or the ``train_step`` given), logs
JAX's line (step, loss, tokens/s) and checkpoints.  There is no ``jit``:
each step runs eagerly on the device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.transformer import init_params, make_train_step
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optim import AdamW


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token ids as int64, float inputs
    (frames, patches) as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def train(
    cfg,
    data_iter,
    *,
    steps: int = 100,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    ckpt_path: str | None = None,
    ckpt_every: int = 0,
    train_step=None,
    params=None,
    opt=None,
    log_fn=print,
    device="cuda",
):
    """Returns (params, [(step, loss), ...] at the logged steps)."""
    opt = opt or AdamW(lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 1))
    params = params if params is not None else init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    opt_state = opt.init(params)
    step_fn = train_step or make_train_step(cfg, opt)
    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = to_device(next(data_iter), device)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if (i + 1) % log_every == 0 or i == 0:
            l = float(loss)
            losses.append((i + 1, l))
            dt = time.time() - t0
            tok = np.prod(batch["tokens"].shape)
            log_fn(f"step {i+1:5d}  loss {l:.4f}  {tok * (i + 1) / dt:.0f} tok/s")
        if ckpt_path and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_path, params, step=i + 1)
    if ckpt_path:
        save_checkpoint(ckpt_path, params, step=steps)
    return params, losses
