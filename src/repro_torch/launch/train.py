"""Training launcher: the counterpart of src/repro/launch/train.py.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 20 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --arch granite-3-2b --steps 5 --batch 2 --seq 32

``--smoke`` trains the reduced config.  Data: SyntheticLM (no corpus
needed) or ``--data <memmap.bin>``.  The encoder-decoder and VLM families
train on seeded stub frames or patches (``add_modality_stubs``), as in JAX.
It runs on ``--device cuda`` (the default) and raises when no CUDA device
is present; ``--device cpu`` trains on the CPU.

``--distributed`` and ``--multi-pod`` raise: they place the JAX package's
production-mesh rules (``param_shardings``, ``opt_shardings``,
``models/act_sharding.py``), which shard weights, optimizer state and
activations over a TPU pod.  On one card there is nothing to shard, so they
are left out; training across cards waits with ROADMAP queue 1 item 8b for
a machine with several.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.training.data import MemmapDataset, SyntheticLM
from repro_torch.training.loop import train
from repro_torch.training.optim import AdamW


def add_modality_stubs(cfg, batch_iter, batch):
    """Attach stub modality embeddings to each batch when the arch needs
    them: the JAX launcher's numpy draws, in its order."""
    if cfg.arch_type not in ("encdec", "vlm"):
        yield from batch_iter
        return
    rng = np.random.default_rng(0)
    for b in batch_iter:
        if cfg.arch_type == "encdec":
            b["enc_embeds"] = rng.standard_normal((batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
        else:
            b["embeds"] = rng.standard_normal((batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
        yield b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default=None, help="packed-token memmap path")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="device to train on (cuda, or cpu)")
    ap.add_argument("--distributed", action="store_true", help="the production mesh (not on one card)")
    ap.add_argument("--multi-pod", action="store_true", help="the multi-pod mesh (not on one card)")
    args = ap.parse_args(argv)

    if args.distributed or args.multi_pod:
        raise NotImplementedError(
            "--distributed/--multi-pod place the production-mesh rules (param_shardings, opt_shardings, "
            "models/act_sharding.py), which have no use on one card and are left out; training across cards "
            "waits for a machine with several (ROADMAP queue 1 item 8b)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is false; "
                           "pass --device cpu to train on the CPU")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    src = MemmapDataset(args.data, cfg.vocab) if args.data else SyntheticLM(cfg.vocab, seed=0)
    it = add_modality_stubs(cfg, src.batches(args.batch, args.seq), args.batch)
    opt = AdamW(lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 20, 1))
    params, losses = train(cfg, it, steps=args.steps, lr=args.lr, ckpt_path=args.ckpt, opt=opt, device=device)
    print(f"final loss: {losses[-1][1]:.4f}")


if __name__ == "__main__":
    main()
