"""Encoder-decoder transformer, the Whisper-large-v3 backbone (port of
``repro.models.encdec``).

The conv frontend is a stub, as in the reference: the caller supplies
precomputed mel-frame embeddings (B, enc_seq, d).  Positions are
sinusoidal on both sides.

Decoder = self-attn (causal, cached) + cross-attn (encoder KV, computed
once at prefill) + MLP.  Both stacks are looped over in Python (the
reference scans them; a scan changes nothing in a forward pass).  While
autograd records a graph and ``cfg.remat`` is not ``none``, each encoder
layer and each cache-free decoder layer runs under ``common.remat``, as
the reference checkpoints its scan bodies.  The
cache is updated in place, and its ``pos`` is a host ``int``.  With
``quant_kv`` the decoder's self-attention gets its cache's scales too
(the reference hands it only ``k`` and ``v``, so its int8 buffers would
take the keys unscaled).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import attention as attn_mod
from . import mlp as mlp_mod
from .base import ModelConfig
from .common import (PSpec, abstract_params, apply_norm, build_params,
                     logical_axes, norm_specs, remat, remat_layer,
                     softmax_cross_entropy, stack_specs)
from .lm import _sinusoid, _unstack


def _enc_block_specs(cfg):
    return {
        "ln1": norm_specs(cfg.norm, cfg.d_model),
        "attn": attn_mod.attn_specs(cfg),
        "ln2": norm_specs(cfg.norm, cfg.d_model),
        "mlp": mlp_mod.mlp_specs(cfg),
    }


def _dec_block_specs(cfg):
    return {
        "ln1": norm_specs(cfg.norm, cfg.d_model),
        "attn": attn_mod.attn_specs(cfg),
        "lnx": norm_specs(cfg.norm, cfg.d_model),
        "xattn": attn_mod.attn_specs(cfg, cross=True),
        "ln2": norm_specs(cfg.norm, cfg.d_model),
        "mlp": mlp_mod.mlp_specs(cfg),
    }


class EncDec:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        d, V = cfg.d_model, cfg.padded_vocab
        return {
            "embed": PSpec((V, d), ("vocab", "fsdp"), "embed", scale=0.02),
            "enc": stack_specs(_enc_block_specs(cfg), cfg.enc_layers),
            "enc_norm": norm_specs(cfg.norm, d),
            "dec": stack_specs(_dec_block_specs(cfg), cfg.num_layers),
            "final_norm": norm_specs(cfg.norm, d),
            "unembed": PSpec((d, V), ("fsdp", "vocab")),
        }

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters drawn from ``generator`` (the reference's
        distributions; the numbers are torch's, not JAX's)."""
        return build_params(self.param_specs(), generator, self.cfg.param_dtype,
                            device)

    def abstract_params(self):
        return abstract_params(self.param_specs(), self.cfg.param_dtype)

    def param_axes(self):
        return logical_axes(self.param_specs())

    # -- encoder ------------------------------------------------------------

    def encode(self, params, encoder_embeds):
        cfg = self.cfg
        x = encoder_embeds.to(params["embed"].dtype)     # the parameters' dtype
        positions = torch.arange(x.shape[1], device=x.device)
        x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
        for p in _unstack(params["enc"], cfg.enc_layers):
            if remat_layer(cfg, x, p):
                x = remat(self._enc_layer, p, x)
            else:
                x = self._enc_layer(p, x)
        return apply_norm(cfg.norm, x, params["enc_norm"])

    def _enc_layer(self, p, x):
        cfg = self.cfg
        a, _ = attn_mod.attention(
            cfg, p["attn"], apply_norm(cfg.norm, x, p["ln1"]), causal=False)
        x = x + a
        return x + mlp_mod.mlp_apply(cfg, p["mlp"], apply_norm(cfg.norm, x, p["ln2"]))

    # -- decoder ------------------------------------------------------------

    def _dec_layer(self, p, h, *, self_cache, cross_kv, pos, enc_out):
        cfg = self.cfg
        acache = None
        if self_cache is not None:
            acache = {**self_cache, "pos": pos}
        a, _ = attn_mod.attention(
            cfg, p["attn"], apply_norm(cfg.norm, h, p["ln1"]), cache=acache)
        h = h + a
        # cross attention: either precomputed KV (prefill, decode) or fresh
        # from enc_out (forward)
        hq = apply_norm(cfg.norm, h, p["lnx"])
        if cross_kv is not None:
            xa, _ = attn_mod.attention(cfg, p["xattn"], hq, cache=cross_kv)
        else:
            xa, _ = attn_mod.attention(cfg, p["xattn"], hq, xkv=enc_out)
        h = h + xa
        return h + mlp_mod.mlp_apply(cfg, p["mlp"], apply_norm(cfg.norm, h, p["ln2"]))

    def _dec_train_layer(self, p, h, enc_out):
        """A cache-free decoder layer (``forward``, the loss)."""
        return self._dec_layer(p, h, self_cache=None, cross_kv=None, pos=None,
                               enc_out=enc_out)

    def _run_decoder(self, params, x, *, cache=None, enc_out=None):
        """Returns (x, cache | None); ``cache`` is updated in place
        (self-attention buffers and ``pos``) and returned."""
        L = self.cfg.num_layers
        p_layers = _unstack(params["dec"], L)
        if cache is None:
            for p in p_layers:
                if remat_layer(self.cfg, x, p, enc_out):
                    x = remat(self._dec_train_layer, p, x, enc_out)
                else:
                    x = self._dec_train_layer(p, x, enc_out)
            return x, None
        pos = cache["pos"]
        for p, sc, xk, xv in zip(p_layers, _unstack(cache["self"], L),
                                 cache["cross_k"].unbind(0), cache["cross_v"].unbind(0)):
            x = self._dec_layer(p, x, self_cache=sc, cross_kv={"k": xk, "v": xv},
                                pos=pos, enc_out=None)
        cache["pos"] = pos + x.shape[1]
        return x, cache

    def _logits(self, params, x):
        x = apply_norm(self.cfg.norm, x, params["final_norm"])
        return x @ params["unembed"].to(x.dtype)

    def _dec_embed(self, params, tokens, pos0: int):
        x = params["embed"][tokens.long()]
        positions = torch.arange(pos0, pos0 + tokens.shape[1], device=x.device)
        return x + _sinusoid(positions, self.cfg.d_model).to(x.dtype)

    # -- public api ---------------------------------------------------------

    def forward(self, params, tokens, encoder_embeds):
        enc_out = self.encode(params, encoder_embeds)
        x = self._dec_embed(params, tokens, 0)
        x, _ = self._run_decoder(params, x, enc_out=enc_out)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32,
                                                    device=x.device)

    def loss(self, params, batch):
        """The reference's loss, the decoder's cross-entropy with its
        z-loss; returns ``(loss, {"ce", "aux", "loss"})``."""
        logits, aux = self.forward(params, batch["tokens"], batch["encoder_embeds"])
        ce = softmax_cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux, "loss": ce}

    def init_cache(self, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   quant_kv: bool = False, device="cuda") -> dict:
        """Zeroed self-attention buffers (int8 with per-position scales
        under ``quant_kv``), the per-layer cross KV of ``dtype`` and a host
        ``int`` position."""
        cfg = self.cfg
        dev = resolve_device(device)
        L = cfg.num_layers
        kv_dtype = torch.int8 if quant_kv else dtype
        shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        xshape = (L, batch, cfg.enc_seq, cfg.num_kv_heads, cfg.head_dim)
        self_cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                      "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}
        if quant_kv:
            self_cache["k_scale"] = torch.zeros(shape[:4] + (1,), dtype=torch.float32,
                                                device=dev)
            self_cache["v_scale"] = torch.zeros(shape[:4] + (1,), dtype=torch.float32,
                                                device=dev)
        return {
            "self": self_cache,
            "cross_k": torch.zeros(xshape, dtype=dtype, device=dev),
            "cross_v": torch.zeros(xshape, dtype=dtype, device=dev),
            "pos": 0,
        }

    def prefill(self, params, tokens, cache, *, encoder_embeds):
        """Encode audio, precompute the cross KV of every layer, prefill the
        decoder's self-attention."""
        cfg = self.cfg
        enc_out = self.encode(params, encoder_embeds)
        B, Se, _ = enc_out.shape
        for l, p in enumerate(_unstack(params["dec"], cfg.num_layers)):
            k = enc_out @ p["xattn"]["wk"]
            v = enc_out @ p["xattn"]["wv"]
            cache["cross_k"][l].copy_(k.reshape(B, Se, cfg.num_kv_heads, cfg.head_dim))
            cache["cross_v"][l].copy_(v.reshape(B, Se, cfg.num_kv_heads, cfg.head_dim))
        x = self._dec_embed(params, tokens, 0)
        x, cache = self._run_decoder(params, x, cache=cache)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, tokens, cache):
        """tokens (B, 1) -> (logits (B,1,V), cache updated in place)."""
        x = self._dec_embed(params, tokens, cache["pos"])
        x, cache = self._run_decoder(params, x, cache=cache)
        return self._logits(params, x), cache
