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

``--distributed`` (the 16x16 ``("data", "model")`` mesh) and
``--multi-pod`` (2x16x16 ``("pod", "data", "model")``) train over the
production mesh with JAX's placements, one process a card:

    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch granite-8b --distributed          # 256 ranks (512 with --multi-pod)

Every rank draws the parameters from the same seed and rank 0's draw is
scattered (``launch.sharding.distribute``): the parameters, AdamW's
moments, each global batch and the activation pins take the placements of
launch/sharding.py and models/act_sharding.py, and DTensor's sharding
propagation places the rest.  ``make_sharded_train_step`` is the step the
dry run's train entries and the tests run on smaller meshes.  Without a
process group of 256 (512) ranks ``make_production_mesh`` raises, naming
the world size it found.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.sharding import batch_shardings, distribute, gather, param_shardings
from repro_torch.models.act_sharding import activation_sharding
from repro_torch.models.transformer import init_params, make_train_step
from repro_torch.training.checkpoint import save_checkpoint
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


def place_params(mesh, cfg, params: dict) -> dict:
    """The parameters as DTensors over ``mesh``, placed by JAX's rules
    (``param_shardings``, mode "train").  ``AdamW.init`` of them gives
    moments placed as ``opt_shardings`` says: zeros like each parameter."""
    return distribute(params, mesh, param_shardings(mesh, params, cfg))


def make_sharded_train_step(cfg, opt, mesh):
    """``make_train_step`` over ``mesh``: JAX's ``jit(step, in_shardings=...)``.
    ``step(params, opt_state, batch) -> (params, opt_state, loss)`` takes
    ``place_params``'s parameters, ``AdamW.init`` of them, and the GLOBAL
    batch as tensors
    (every rank the same), placed by ``batch_shardings``; the activation
    pins are installed on the data axes for the step, and the loss comes
    back whole."""
    step = make_train_step(cfg, opt)
    axes = data_axes(mesh)

    def sharded_step(params, opt_state, batch):
        batch = distribute(batch, mesh, batch_shardings(mesh, batch))
        with implicit_replication(), activation_sharding(mesh, axes):
            params, opt_state, loss = step(params, opt_state, batch)
        return params, opt_state, loss.full_tensor() if isinstance(loss, DTensor) else loss

    return sharded_step


def _production_setup(args, device):
    """(device, mesh, log_fn) of a ``--distributed`` run: the process group
    ``torchrun`` describes in the environment (none without it, and then
    ``make_production_mesh`` raises) and the production mesh over it."""
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=device.type)
    return device, mesh, print if dist.get_rank() == 0 else (lambda *_: None)


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
    ap.add_argument("--distributed", action="store_true", help="train over the 16x16 production mesh")
    ap.add_argument("--multi-pod", action="store_true", help="train over the 2x16x16 production mesh")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is false; "
                           "pass --device cpu to train on the CPU")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    src = MemmapDataset(args.data, cfg.vocab) if args.data else SyntheticLM(cfg.vocab, seed=0)
    it = add_modality_stubs(cfg, src.batches(args.batch, args.seq), args.batch)
    opt = AdamW(lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 20, 1))
    if not (args.distributed or args.multi_pod):
        params, losses = train(cfg, it, steps=args.steps, lr=args.lr, ckpt_path=args.ckpt, opt=opt, device=device)
        print(f"final loss: {losses[-1][1]:.4f}")
        return
    device, mesh, log = _production_setup(args, device)
    try:
        params = place_params(mesh, cfg, init_params(cfg, torch.Generator(device=device).manual_seed(0)))
        params, losses = train(cfg, it, steps=args.steps, lr=args.lr, opt=opt, device=device, params=params,
                               train_step=make_sharded_train_step(cfg, opt, mesh), log_fn=log)
        if args.ckpt:
            whole = gather(params)  # a collective: every rank gathers, rank 0 writes
            if dist.get_rank() == 0:
                save_checkpoint(args.ckpt, whole, step=args.steps)
        log(f"final loss: {losses[-1][1]:.4f}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
