"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a few
hundred steps with checkpointing and automatic restart recovery.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps N] [--arch ID] \
        [--ckpt DIR] [--device cuda|cpu]

Re-running the same command resumes from the latest checkpoint (default
``build/train_lm_torch`` in the repository, which git ignores).  The
default device is the card; ``--device cpu`` runs the same model there,
slowly.
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import make_host_mesh
from repro_torch.models import get_model
from repro_torch.runtime import Trainer

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--arch", default="internvl2-1b")
ap.add_argument("--ckpt", default=str(Path(__file__).resolve().parents[1] / "build"
                                      / "train_lm_torch"))
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# ~100M-param sibling of the assigned arch (12 layers, d=512)
cfg = dataclasses.replace(
    get_config(args.arch),
    num_layers=12, d_model=512, num_heads=8, num_kv_heads=2, head_dim=64,
    d_ff=2048, vocab_size=32_000, num_prefix_tokens=0, dtype="float32",
    remat="none", attn_chunk=128,
)
model = get_model(cfg)
n = sum(x.numel() for x in optim.adamw.tree_leaves(model.abstract_params()))
print(f"arch={cfg.arch}-sibling params={n/1e6:.1f}M device={args.device}")

pipe = TokenPipeline(cfg.vocab_size, batch=8, seq_len=256, seed=0)
trainer = Trainer(
    model, mesh=make_host_mesh(device=args.device), pipeline=pipe,
    opt_cfg=optim.AdamWConfig(lr=3e-4, warmup_steps=20,
                              total_steps=args.steps),
    ckpt_dir=args.ckpt, ckpt_every=50,
)
history = trainer.run(args.steps, log_every=10)
if history:
    print(f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f} "
          f"over {len(history)} steps (straggler events: "
          f"{len(trainer.monitor.events)})")
