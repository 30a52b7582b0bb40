"""Serving example on the PyTorch port: batched prefill + greedy decode
with a KV cache (optionally int8-quantized), on the card by default.

    PYTHONPATH=src python examples/serve_lm_torch.py [--quant-kv] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import get_model

ap = argparse.ArgumentParser()
ap.add_argument("--quant-kv", action="store_true")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--prompt-len", type=int, default=64)
ap.add_argument("--gen", type=int, default=32)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = reduce_config(get_config("qwen1.5-4b"),
                    num_layers=4, d_model=128, num_heads=8, num_kv_heads=4,
                    head_dim=16, d_ff=512, vocab_size=4096)
model = get_model(cfg)
params = model.init(torch.Generator(device=dev).manual_seed(0), dev)

B, P, G = args.batch, args.prompt_len, args.gen
prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
out = generate(model, params, prompts, G, quant_kv=args.quant_kv)

kv = "int8" if args.quant_kv else "f32"
print(f"served batch={B} prompt={P} gen={G} (kv cache: {kv}, device: {args.device})")
print(f"prefill {out['prefill_ms']:.1f} ms; decode {out['decode_ms_per_token']:.2f} "
      f"ms/token; sample tokens: {out['tokens'][0, :10].tolist()}")
