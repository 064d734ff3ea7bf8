"""Neural delay-and-branch predictor (NDE) — Sec. 6 and Appendix E, in torch.

The counterpart of src/repro/core/selector.py.  A lightweight MLP policy
over the delayed-expansion action space
A = {1..K_max} x {0..L1_max} x {0..L2_max}.  Inputs (App. E):

  * hidden-state blocks:  h_prev^p, h_prev^q (target/draft states at the
    preceding token) and h_cur^q (draft state at the root token) — each
    linearly projected to d=128 + LayerNorm,
  * standardized scalar features: entropies H(p_prev), H(q_prev), H(q_root),
    KL(p_prev||q_prev), KL(q_prev||p_prev), ||p_prev - q_prev||_1,
    context length, temperature, nucleus threshold, and draft/target latency
    estimates at the current context length,
  * two-hidden-layer MLP (512 -> 32) with GELU + dropout -> |A| logits.

Parameters are a dict of dense layers ``{"w": (din, dout), "b": (dout,)}``
with the JAX package's names and layout (``x @ w + b``), float32 tensors,
so ``bridge.selector_params_from_jax`` is a leaf-by-leaf copy.  The action
order, the initial distributions, GELU's tanh form, the LayerNorm without
an affine part and the inverted dropout are those of the JAX module; random
draws come from an explicit ``torch.Generator``.

Training (Eq. 4/5/12): maximise the policy-averaged offline throughput
estimate against a static per-sampling-config baseline action, with a CVaR
penalty on the worst alpha-fraction of baseline regressions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ActionSpace:
    K_max: int = 4
    L1_max: int = 8
    L2_max: int = 8

    def actions(self) -> list[tuple[int, int, int]]:
        # (K, L1, L2); drop degenerate duplicates: L1+L2 == 0 drafts nothing,
        # and K>1 with L2 == 0 is identical to K=1 with the same L1.
        out = []
        for K in range(1, self.K_max + 1):
            for L1 in range(self.L1_max + 1):
                for L2 in range(self.L2_max + 1):
                    if L1 + L2 == 0:
                        continue
                    if K > 1 and L2 == 0:
                        continue
                    out.append((K, L1, L2))
        return out

    @property
    def n(self) -> int:
        return len(self.actions())


class FixedSpace:
    """An explicit action grid (used when offline labels cover a subset)."""

    def __init__(self, actions: list[tuple[int, int, int]]):
        self._actions = list(actions)

    def actions(self) -> list[tuple[int, int, int]]:
        return self._actions

    @property
    def n(self) -> int:
        return len(self._actions)


@dataclass(frozen=True)
class SelectorConfig:
    hidden_p: int = 64     # dim of target hidden states fed in
    hidden_q: int = 64     # dim of draft hidden states fed in
    d_proj: int = 128
    mlp_hidden: tuple = (512, 32)
    n_scalars: int = 11
    dropout: float = 0.1
    space: ActionSpace = field(default_factory=ActionSpace)


LAYERS = ("proj_hp", "proj_hq", "proj_hc", "mlp0", "mlp1", "out")


def init_selector(cfg: SelectorConfig, generator: torch.Generator, device="cuda") -> dict:
    """Weights N(0, 1/din), biases 0, float32, drawn from ``generator`` in
    the order of ``LAYERS`` (the generator must live on ``device``)."""
    n_act = cfg.space.n
    d_in = 3 * cfg.d_proj + cfg.n_scalars
    dims = {
        "proj_hp": (cfg.hidden_p, cfg.d_proj),
        "proj_hq": (cfg.hidden_q, cfg.d_proj),
        "proj_hc": (cfg.hidden_q, cfg.d_proj),
        "mlp0": (d_in, cfg.mlp_hidden[0]),
        "mlp1": (cfg.mlp_hidden[0], cfg.mlp_hidden[1]),
        "out": (cfg.mlp_hidden[1], n_act),
    }
    params = {}
    for name in LAYERS:
        din, dout = dims[name]
        w = torch.randn((din, dout), generator=generator, dtype=torch.float32, device=device) / math.sqrt(din)
        params[name] = {"w": w, "b": torch.zeros((dout,), dtype=torch.float32, device=device)}
    return params


def _ln(x: torch.Tensor) -> torch.Tensor:
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - m) / torch.sqrt(v + 1e-6)


def _apply_dense(layer: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ layer["w"] + layer["b"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def selector_logits(
    params: dict,
    h_prev_p: torch.Tensor,
    h_prev_q: torch.Tensor,
    h_cur_q: torch.Tensor,
    scalars: torch.Tensor,
    *,
    generator: torch.Generator | None = None,
    dropout: float = 0.0,
) -> torch.Tensor:
    """Eq. 10.  Inputs may carry a leading batch axis.  Dropout runs only
    with a ``generator`` to draw its mask from."""
    z = torch.cat(
        [
            _ln(_apply_dense(params["proj_hp"], h_prev_p)),
            _ln(_apply_dense(params["proj_hq"], h_prev_q)),
            _ln(_apply_dense(params["proj_hc"], h_cur_q)),
            scalars,
        ],
        dim=-1,
    )
    h = _gelu(_apply_dense(params["mlp0"], z))
    if generator is not None and dropout > 0:
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - dropout
        h = torch.where(keep, h / (1.0 - dropout), torch.zeros((), dtype=h.dtype, device=h.device))
    h = _gelu(_apply_dense(params["mlp1"], h))
    return _apply_dense(params["out"], h)


def make_scalar_features(
    p_prev: np.ndarray,
    q_prev: np.ndarray,
    q_root: np.ndarray,
    ctx_len: int,
    temperature: float,
    top_p: float,
    t_q: float,
    t_p: float,
) -> np.ndarray:
    """App. E scalar feature block (11 features, standardized by the caller
    or absorbed by the first dense layer)."""

    def H(d):
        d = np.clip(d, 1e-12, None)
        return float(-(d * np.log(d)).sum())

    def KL(a, b):
        a = np.clip(a, 1e-12, None)
        b = np.clip(b, 1e-12, None)
        return float((a * (np.log(a) - np.log(b))).sum())

    return np.asarray(
        [
            H(p_prev),
            H(q_prev),
            H(q_root),
            KL(p_prev, q_prev),
            KL(q_prev, p_prev),
            float(np.abs(p_prev - q_prev).sum()),
            np.log1p(float(ctx_len)),
            float(temperature),
            float(top_p),
            float(t_q) * 1e3,
            float(t_p) * 1e3,
        ],
        dtype=np.float32,
    )


# ------------------------------------------------------------- training ------


def selector_loss(
    params: dict,
    batch: dict,
    *,
    lam: float = 1.0,
    cvar_alpha: float = 0.25,
    aux_ce: float = 0.5,
    ce_temp: float = 0.05,
    generator: torch.Generator | None = None,
    dropout: float = 0.0,
) -> torch.Tensor:
    """Eq. 12 + optimal-action distillation (see the JAX module for why the
    auxiliary cross-entropy against the per-root TPS-softmax target is
    there).

    batch:
      h_prev_p (B, Hp), h_prev_q (B, Hq), h_cur_q (B, Hq), scalars (B, S),
      eff   (B, A): offline block-efficiency estimates E^[tau+1] per action
      time  (B, A): Eq. 11 wall-clock estimates per action
      base  (B,)  : index of the static baseline action
    """
    logits = selector_logits(
        params,
        batch["h_prev_p"],
        batch["h_prev_q"],
        batch["h_cur_q"],
        batch["scalars"],
        generator=generator,
        dropout=dropout,
    )
    pi = torch.softmax(logits, dim=-1)
    tps = batch["eff"] / batch["time"].clamp_min(1e-9)  # (B, A)
    tps_pi = (pi * batch["eff"]).sum(dim=-1) / (pi * batch["time"]).sum(dim=-1)  # Eq. 4
    b = batch["base"].long()
    eff_b = torch.take_along_dim(batch["eff"], b[:, None], dim=-1)[:, 0]
    time_b = torch.take_along_dim(batch["time"], b[:, None], dim=-1)[:, 0]
    tps_base = eff_b / time_b
    ratio = tps_pi / tps_base.clamp_min(1e-9)
    main = -torch.log(ratio.clamp_min(1e-9))  # Eq. 5
    pen = torch.square((1.0 - ratio).clamp_min(0.0))
    # CVaR over the worst alpha-fraction of the minibatch penalties
    B = pen.shape[0]
    k = max(int(np.ceil(cvar_alpha * B)), 1)
    topk = torch.topk(pen, k).values
    loss = main.mean() + lam * topk.mean()
    if aux_ce > 0:
        tps_n = tps / tps.amax(dim=-1, keepdim=True)
        target = torch.softmax(tps_n / ce_temp, dim=-1)
        ce = -(target * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
        loss = loss + aux_ce * ce.mean()
    return loss


def select_action(
    params: dict, h_prev_p, h_prev_q, h_cur_q, scalars, space: ActionSpace
) -> tuple[int, int, int]:
    """Inference: argmax_a pi(a|c)."""
    with torch.no_grad():
        logits = selector_logits(params, h_prev_p, h_prev_q, h_cur_q, scalars)
    idx = int(torch.argmax(logits.reshape(-1)))
    return space.actions()[idx]
