"""Step-function builders for serving (port of the serving half of
``repro.launch.steps``): prefill and greedy decode.  ``make_train_step``
waits for the port of training.
"""
from __future__ import annotations

from typing import Any

import torch


def greedy(logits) -> torch.Tensor:
    """The next token of each sequence, on the device: argmax of the last
    position's logits (B, S, V) -> (B,) int32."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_prefill_step(model):
    def prefill_step(params, cache, batch):
        kw: dict[str, Any] = {}
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        if "encoder_embeds" in batch:
            kw["encoder_embeds"] = batch["encoder_embeds"]
        return model.prefill(params, batch["tokens"], cache, **kw)

    return prefill_step


def make_decode_step(model, logits_out: list | None = None):
    """decode_step(params, cache, batch) -> (next token ids (B,) int32,
    cache).  Serving returns token ids, not logits, to keep the host
    transfer tiny; a caller that checks the logits passes ``logits_out``,
    a list to which each step appends its (B, V) logits (device tensors)."""
    def decode_step(params, cache, batch):
        logits, cache = model.decode_step(params, batch["tokens"], cache)
        if logits_out is not None:
            logits_out.append(logits[:, -1])
        return greedy(logits), cache

    return decode_step
