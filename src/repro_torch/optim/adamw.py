"""AdamW from scratch (port of ``repro.optim.adamw``) on trees of tensors:
dicts (nested or flat) with tensor leaves in place of pytrees.

Moments are fp32 regardless of param dtype (bf16 training keeps master
statistics in fp32).  Supports decoupled weight decay (not on 1-D leaves:
norms and biases), global-norm gradient clipping, and warmup + cosine,
linear or constant schedules.  ``apply_updates`` returns new trees and
leaves its inputs as they were, as the reference does.  The reference's
``decay_mask`` argument, which its update never reads, is not carried.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"   # cosine | constant | linear


def tree_map(fn, *trees):
    """``fn`` leaf by leaf over trees of one structure (dicts of tensors)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The schedule's learning rate at ``step`` (a 0-d float32 tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * t
        else:
            decay = cfg.min_lr_ratio + 0.5 * (1 - cfg.min_lr_ratio) * (
                1 + torch.cos(math.pi * t))
    return cfg.lr * warm * decay


def init_state(params) -> dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    return {"mu": tree_map(zeros32, params), "nu": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device if leaves else None)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu):
        g32 = g.float() * scale
        mu2 = cfg.b1 * mu + (1 - cfg.b1) * g32
        nu2 = cfg.b2 * nu + (1 - cfg.b2) * g32.square()
        delta = (mu2 / b1c) / (torch.sqrt(nu2 / b2c) + cfg.eps)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0   # no decay on norms/bias
        p2 = p.float() - lr * (delta + wd * p.float())
        return p2.to(p.dtype), mu2, nu2

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_p, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, {"mu": mu, "nu": nu, "step": step}, {"grad_norm": gnorm, "lr": lr}
