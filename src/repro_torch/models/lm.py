"""Decoder-only LM assembly (port of ``repro.models.lm``): segments of
stacked blocks with KV and SSM caches threaded through them, modality
prefixes (VLM patch embeddings), Hymba meta tokens and the
CPD-factorized embedding.

A model is a list of ``Segment``s.  Dense, MoE and Mamba2 archs have one
segment; Hymba is [global, swa-stack, global, swa-stack, global] so its
sliding-window layers carry a different mask and window-sized ring
caches.  ``LM`` runs every decoder-only family (``dense``, ``vlm``,
``moe``, ``ssm``, ``hybrid``); Whisper's ``encdec`` is ``EncDec``
(``encdec.py``), and ``model_segments`` refuses it.

The parameter tree is the reference's: a stacked segment keeps its
leading layer axis, so ``repro_torch.convert.params_from_reference``
carries a model's parameters unchanged.  ``_run_segments`` loops over the
layers' views in Python; the reference's ``lax.scan`` changes nothing in
a forward pass, so ``scan_layers`` is not read here.  ``remat`` is read
only while autograd records a graph (training): then each layer of a
cache-free pass runs under ``common.remat``, a per-layer activation
checkpoint, for ``full`` and ``dots`` alike, and each chunk of the
chunked cross-entropy is checkpointed too, as the reference's are.  The
values are those of a plain pass; only the memory differs.  The cache is
updated in place (``attention.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from ..device import resolve_device
from . import blocks as blk
from . import factorized_embed as fe
from .base import ModelConfig
from .common import (PSpec, abstract_params, apply_norm, build_params,
                     logical_axes, norm_specs, records_grad, remat, remat_layer,
                     softmax_cross_entropy, stack_specs)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # dense | moe | mamba | hymba
    n_layers: int
    window: int = 0    # sliding-window size for attention (0 = full)
    name: str = ""


def model_segments(cfg: ModelConfig) -> list[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("dense", cfg.num_layers, cfg.attn_window, "layers")]
    if cfg.family == "moe":
        return [Segment("moe", cfg.num_layers, 0, "layers")]
    if cfg.family == "ssm":
        return [Segment("mamba", cfg.num_layers, 0, "layers")]
    if cfg.family == "hybrid":
        # global full-attention layers at first / middle / last (Hymba).
        g = sorted(set(cfg.global_attn_layers or (0, cfg.num_layers // 2,
                                                  cfg.num_layers - 1)))
        segs: list[Segment] = []
        prev = 0
        for i, gl in enumerate(g):
            if gl > prev:
                segs.append(Segment("hymba", gl - prev, cfg.attn_window,
                                    f"swa_{i}"))
            segs.append(Segment("hymba", 1, 0, f"global_{gl}"))
            prev = gl + 1
        if prev < cfg.num_layers:
            segs.append(Segment("hymba", cfg.num_layers - prev,
                                cfg.attn_window, "swa_tail"))
        return segs
    raise ValueError(f"family {cfg.family!r} not handled by lm.py")


def _unstack(tree, n: int) -> list:
    """The n per-layer views of a tree whose leaves have a leading layer axis."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return tree.unbind(0)


class LM:
    """Functional decoder-only language model."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.segments = model_segments(cfg)

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        d, V = cfg.d_model, cfg.padded_vocab
        specs: dict[str, Any] = {"final_norm": norm_specs(cfg.norm, d)}
        if cfg.cpd_embed_rank:
            specs["embed_cpd"] = fe.cpd_embed_specs(V, d, cfg.cpd_embed_rank)
            specs["unembed"] = PSpec((d, V), ("fsdp", "vocab"))
        else:
            specs["embed"] = PSpec((V, d), ("vocab", "fsdp"), "embed",
                                   scale=0.02)
            if not cfg.tie_embeddings:
                specs["unembed"] = PSpec((d, V), ("fsdp", "vocab"))
        if cfg.num_meta_tokens:
            specs["meta_tokens"] = PSpec(
                (cfg.num_meta_tokens, d), (None, "fsdp"), "normal", scale=0.02
            )
        segs = {}
        for i, seg in enumerate(self.segments):
            s = blk.block_specs(cfg, seg.kind)
            segs[f"seg{i}_{seg.name or seg.kind}"] = (
                stack_specs(s, seg.n_layers) if seg.n_layers > 1 else s
            )
        specs["segments"] = segs
        return specs

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters drawn from ``generator`` (the reference's
        distributions; the numbers are torch's, not JAX's)."""
        return build_params(self.param_specs(), generator, self.cfg.param_dtype,
                            device)

    def abstract_params(self):
        return abstract_params(self.param_specs(), self.cfg.param_dtype)

    def param_axes(self):
        return logical_axes(self.param_specs())

    def _seg_keys(self) -> list[str]:
        return [f"seg{i}_{s.name or s.kind}" for i, s in enumerate(self.segments)]

    # -- caches -------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   quant_kv: bool = False, device="cuda") -> dict:
        """Zeroed buffers, stacked per segment as the parameters are, and a
        host ``int`` position.  ``dtype`` is the KV cache's; the SSM state
        is float32 and the conv window the parameters' dtype
        (``blocks.init_block_cache``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches: dict[str, Any] = {"pos": 0}
        total = max_len + cfg.num_meta_tokens + cfg.num_prefix_tokens
        for i, seg in enumerate(self.segments):
            # window-limited segments cap their buffers at the window
            seg_len = total if not seg.window else min(total, seg.window)
            one = blk.init_block_cache(cfg, seg.kind, batch, seg_len,
                                       dtype, quant_kv, dev)
            if seg.n_layers > 1:
                one = {k: torch.zeros((seg.n_layers, *a.shape), dtype=a.dtype,
                                      device=dev) for k, a in one.items()}
            caches[self._seg_keys()[i]] = one
        return caches

    # -- forward ------------------------------------------------------------

    def _tok_embed(self, params, tokens):
        cfg = self.cfg
        if cfg.cpd_embed_rank:
            return fe.cpd_embed_lookup(
                params["embed_cpd"], tokens, cfg.padded_vocab
            ).to(cfg.param_dtype)
        return params["embed"][tokens.long()]

    def _embed(self, params, tokens, prefix_embeds=None):
        cfg = self.cfg
        x = self._tok_embed(params, tokens)
        n_prefix = 0
        if cfg.num_meta_tokens and "meta_tokens" in params:
            meta = params["meta_tokens"][None].expand(
                x.shape[0], cfg.num_meta_tokens, cfg.d_model).to(x.dtype)
            x = torch.cat([meta, x], dim=1)
            n_prefix += cfg.num_meta_tokens
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
            n_prefix += prefix_embeds.shape[1]
        if cfg.pos_embedding == "sinusoidal":
            positions = torch.arange(x.shape[1], device=x.device)
            x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
        return x, n_prefix

    def _run_segments(self, params, x, *, caches=None, q0=0, train=False):
        """Returns (x, caches | None, aux).  ``caches`` is updated in place
        (buffers and ``pos``) and returned."""
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        pos = caches["pos"] if caches is not None else None
        keys = self._seg_keys()

        for i, seg in enumerate(self.segments):
            p_seg = params["segments"][keys[i]]
            c_seg = caches.get(keys[i]) if caches is not None else None
            if seg.n_layers > 1:
                p_layers = _unstack(p_seg, seg.n_layers)
                c_layers = (_unstack(c_seg, seg.n_layers) if c_seg is not None
                            else [None] * seg.n_layers)
            else:
                p_layers, c_layers = [p_seg], [c_seg]
            for p_li, c_li in zip(p_layers, c_layers):
                if c_li is None and remat_layer(cfg, x, p_li):
                    x, _, a = remat(functools.partial(
                        blk.block_apply, cfg, seg.kind, window=seg.window, q0=q0,
                        train=train), p_li, x)
                else:
                    x, _, a = blk.block_apply(cfg, seg.kind, p_li, x, cache=c_li,
                                              pos=pos, window=seg.window, q0=q0,
                                              train=train)
                if a is not None:
                    aux_total = aux_total + a
        if caches is not None:
            # advance the shared position cursor by the query length
            caches["pos"] = pos + x.shape[1]
        return x, caches, aux_total

    def _logits(self, params, x):
        cfg = self.cfg
        x = apply_norm(cfg.norm, x, params["final_norm"])
        un = (params["embed"].T
              if cfg.tie_embeddings and not cfg.cpd_embed_rank
              else params["unembed"])
        return x @ un.to(x.dtype)

    def forward(self, params, tokens, *, prefix_embeds=None, train=False):
        x, n_prefix = self._embed(params, tokens, prefix_embeds)
        x, _, aux = self._run_segments(params, x, train=train)
        logits = self._logits(params, x)
        return logits[:, n_prefix:], aux

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """The reference's loss: the cross-entropy with its z-loss, plus
        0.01 x the blocks' auxiliary (MoE load-balance) loss; returns
        ``(loss, {"ce", "aux", "loss"})``.  ``launch.steps`` differentiates
        it."""
        cfg = self.cfg
        if cfg.loss_chunk:
            # chunked CE: never materializes the full (B, S, V) f32 logits;
            # per-chunk logits are rematerialized in the backward
            x, n_prefix = self._embed(params, batch["tokens"],
                                      batch.get("prefix_embeds"))
            x, _, aux = self._run_segments(params, x, train=True)
            x = x[:, n_prefix:]
            labels = batch["labels"]
            C = cfg.loss_chunk
            S = x.shape[1]
            nc = -(-S // C)
            x = torch.nn.functional.pad(x, (0, 0, 0, nc * C - S))
            labels = torch.nn.functional.pad(labels, (0, nc * C - S), value=-1)

            def chunk_ce(xch, lch):
                logits = self._logits(params, xch).float()
                lse = torch.logsumexp(logits, dim=-1)
                safe = torch.clamp(lch, min=0).long()
                ll = torch.gather(logits, -1, safe[..., None])[..., 0]
                ce_i = (lse - ll) + 1e-4 * lse**2
                valid = (lch >= 0).float()
                return (ce_i * valid).sum(), valid.sum()

            record = records_grad(x, params)
            ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            n = torch.zeros((), dtype=torch.float32, device=x.device)
            for c in range(nc):
                xch, lch = x[:, c * C:(c + 1) * C], labels[:, c * C:(c + 1) * C]
                s_c, n_c = remat(chunk_ce, xch, lch) if record else chunk_ce(xch, lch)
                ce_sum = ce_sum + s_c
                n = n + n_c
            ce = ce_sum / torch.clamp(n, min=1.0)
            loss = ce + 0.01 * aux
            return loss, {"ce": ce, "aux": aux, "loss": loss}
        logits, aux = self.forward(
            params, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
            train=True,
        )
        ce = softmax_cross_entropy(logits, batch["labels"])
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    # -- serving ------------------------------------------------------------

    def prefill(self, params, tokens, cache, *, prefix_embeds=None):
        x, n_prefix = self._embed(params, tokens, prefix_embeds)
        x, cache2, _ = self._run_segments(params, x, caches=cache)
        logits = self._logits(params, x[:, -1:])
        return logits, cache2

    def decode_step(self, params, tokens, cache):
        """tokens (B, 1) -> (logits (B,1,V), cache updated in place)."""
        cfg = self.cfg
        x = self._tok_embed(params, tokens)
        if cfg.pos_embedding == "sinusoidal":
            pos = torch.arange(cache["pos"], cache["pos"] + 1, device=x.device)
            x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
        x, cache2, _ = self._run_segments(params, x, caches=cache)
        return self._logits(params, x), cache2


def _sinusoid(positions, d):
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                     * (math.log(10000.0) / half))
    ang = positions.float()[:, None] * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]
