"""Serving example on the PyTorch port: batched prefill + greedy decode
with a KV cache (optionally int8-quantized), on the card by default.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch A] [--quant-kv] \
        [--device cpu]

Any arch of ``repro_torch.configs.ARCHS`` (dbrx-132b does not fit one
card): full width on the card, the reduced config on the CPU.  Whisper
(``whisper-large-v3``) is served with random encoder frames in place of
its audio frontend.
"""
import argparse

import torch

from repro_torch.configs import ARCHS, get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import get_model

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen1.5-4b", choices=list(ARCHS))
ap.add_argument("--quant-kv", action="store_true")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--prompt-len", type=int, default=64)
ap.add_argument("--gen", type=int, default=32)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = get_config(args.arch)
if dev.type == "cpu":
    cfg = reduce_config(cfg)
model = get_model(cfg)
params = model.init(torch.Generator(device=dev).manual_seed(0), dev)

B, P, G = args.batch, args.prompt_len, args.gen
prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
kw = {}
if cfg.enc_layers:
    kw["encoder_embeds"] = 0.1 * torch.randn(
        (B, cfg.enc_seq, cfg.d_model), device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))
if cfg.num_prefix_tokens:
    kw["prefix_embeds"] = 0.02 * torch.randn(
        (B, cfg.num_prefix_tokens, cfg.d_model), device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))
out = generate(model, params, prompts, G, quant_kv=args.quant_kv, **kw)

kv = "int8" if args.quant_kv else "f32"
print(f"served {args.arch} ({cfg.family}, {cfg.num_layers} layers, d_model "
      f"{cfg.d_model}) batch={B} prompt={P} gen={G} (kv cache: {kv}, device: {args.device})")
print(f"prefill {out['prefill_ms']:.1f} ms; decode {out['decode_ms_per_token']:.2f} "
      f"ms/token; sample tokens: {out['tokens'][0, :10].tolist()}")
