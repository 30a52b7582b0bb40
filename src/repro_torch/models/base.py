"""Model configuration + assigned input-shape registry (port of
``repro.models.base``).

Every assigned architecture instantiates ``ModelConfig`` (exact numbers in
repro_torch/configs/<id>.py).  ``SHAPES`` is the assignment's per-arch
shape set; ``token_specs`` gives tensors on the ``meta`` device (shape
and dtype, no storage) where the reference gives ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .common import pad_vocab


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    qkv_bias: bool = False
    pos_embedding: str = "rope"               # rope | sinusoidal
    rope_theta: float = 10_000.0
    attn_window: int = 0                      # 0 = full causal
    global_attn_layers: tuple[int, ...] = ()  # hybrid: full-attn layer ids
    attn_chunk: int = 512                     # online-softmax q-chunk

    # mlp
    activation: str = "swiglu"                # swiglu | gelu | geglu
    norm: str = "rmsnorm"
    tie_embeddings: bool = False

    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dff: int = 0
    capacity_factor: float = 1.25

    # ssm (mamba2 / hymba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # hybrid (hymba)
    num_meta_tokens: int = 0

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                          # encoder frames (stub frontend)

    # vlm
    num_prefix_tokens: int = 0                # visual patch embeddings

    # numerics / execution
    dtype: str = "bfloat16"
    remat: str = "full"                       # none | full | dots
    scan_layers: bool = True                  # False: unroll (exact HLO costs)
    vocab_round: int = 256

    # perf levers (§Perf hillclimb; default False == paper-faithful baseline)
    attn_bf16_dot: bool = False               # bf16 MXU dots w/ f32 accum
    moe_dense_eval: bool = False              # dispatch-free MoE (fine-grained)
    loss_chunk: int = 0                       # chunked CE (tokens per chunk)

    # the paper's technique as an LM feature: CPD-factorized embedding
    # table of this rank (0 = dense table); see models/factorized_embed.py
    cpd_embed_rank: int = 0

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size, self.vocab_round)

    @property
    def param_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:                 # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode at 500k context without full quadratic attn?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND."""
        d, L = self.d_model, self.num_layers
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        n = emb
        qf = self.num_heads * self.head_dim
        kf = self.num_kv_heads * self.head_dim
        attn = d * qf + 2 * d * kf + qf * d
        if self.family == "ssm":
            n += L * _mamba_params(self)
        elif self.family == "hybrid":
            mlp = 3 * d * self.d_ff
            n += L * (attn + _mamba_params(self) + mlp)
        else:
            if self.num_experts:
                mlp = self.num_experts * 3 * d * self.moe_dff + d * self.num_experts
            else:
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                mlp = mult * d * self.d_ff
            n += L * (attn + mlp)
            if self.enc_layers:
                n += self.enc_layers * (attn + 2 * d * self.d_ff)
                n += self.num_layers * (d * qf + 2 * d * kf + qf * d)  # cross attn
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        full = self.param_count()
        moe_all = L * self.num_experts * 3 * d * self.moe_dff
        moe_active = L * self.num_experts_per_tok * 3 * d * self.moe_dff
        return int(full - moe_all + moe_active)


def _mamba_params(cfg: "ModelConfig") -> int:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * G * N
    return (
        d * (2 * di + 2 * G * N + H)      # in_proj
        + cfg.conv_kernel * conv_dim      # depthwise conv
        + di * d                          # out_proj
        + 3 * H + di                      # A_log, D, dt_bias, norm
    )


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Per-assignment skip rules. Returns (runnable, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.arch} is pure full-attention (skip per assignment)"
        )
    return True, ""


def token_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict[str, Any]:
    """``meta`` tensors of the inputs of this (arch, shape)'s step function.

    train:   tokens/labels (B, S); modality stubs add prefix embeddings.
    prefill: tokens (B, S) (+ stubs); produces logits + cache.
    decode:  tokens (B, 1) + cache of length S (built by the concrete
             model's ``init_cache``, not here).
    """
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    specs: dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = spec((B, S), torch.int32)
        specs["labels"] = spec((B, S), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = spec((B, S), torch.int32)
    else:  # decode
        specs["tokens"] = spec((B, 1), torch.int32)
    if cfg.num_prefix_tokens and shape.kind != "decode":
        specs["prefix_embeds"] = spec((B, cfg.num_prefix_tokens, cfg.d_model),
                                      torch.bfloat16)
    if cfg.enc_layers and shape.kind != "decode":
        specs["encoder_embeds"] = spec((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return specs
