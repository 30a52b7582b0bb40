"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --steps 1000 --batch 32 --seq 512 --ckpt /tmp/run1 [--reduced] \
        [--device cuda|cpu]

The device defaults to ``cuda`` and raises without a card; ``--device
cpu`` trains the reduced config, as the reference does on a CPU backend.
Every arch trains with the reference's edits: no VLM prefix tokens
(``num_prefix_tokens=0``) and no encoder (``enc_layers=0``).  Re-running
the same command resumes from the newest committed checkpoint
(crash/preemption recovery); a run on another number of ranks restores
elastically.

One process per rank.  A single rank needs no process group; several
come up under ``torchrun --nproc-per-node=κ -m repro_torch.launch.train
...``, each rank joining through ``launch.init_ranks`` from torchrun's
``RANK`` and ``WORLD_SIZE``, as the reference's binary runs once per
host.  The reference's ``--production-mesh`` (a 16 x 16 TPU mesh) is
not carried.  ``make_trainer`` is the work: ``main`` and
``chip_smoke.py`` both call it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch.distributed as dist

from .. import optim
from ..configs import ARCHS, get_config, reduce_config
from ..data import TokenPipeline
from ..device import resolve_device
from ..models import get_model
from ..runtime import Trainer
from .mesh import init_ranks, make_host_mesh


def make_trainer(arch: str = "internvl2-1b", *, steps: int = 200, batch: int = 8,
                 seq: int = 256, lr: float = 3e-4, ckpt: str | None = None,
                 ckpt_every: int = 100, microbatch: int = 1, reduced: bool = False,
                 seed: int = 0, device="cuda", mesh=None) -> Trainer:
    """The launcher's ``Trainer``: ``arch``'s config (reduced with
    ``reduced`` or on the CPU; no prefix tokens, no encoder), a token
    pipeline of ``batch`` x ``seq`` from ``seed`` sliced for this rank of
    ``mesh`` (default ``make_host_mesh``), AdamW at ``lr`` with
    ``steps // 20`` warmup steps and a cosine decay over ``steps``.  Its
    parameters are drawn from seed 0 (``Trainer.initialize``) unless a
    checkpoint in ``ckpt`` restores them."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced or dev.type == "cpu":
        cfg = reduce_config(cfg)
    cfg = dataclasses.replace(cfg, num_prefix_tokens=0, enc_layers=0)
    if mesh is None:
        mesh = make_host_mesh(device=dev)
    pipe = TokenPipeline(cfg.vocab_size, batch=batch, seq_len=seq, seed=seed,
                         process_index=mesh.rank, process_count=mesh.size)
    return Trainer(
        get_model(cfg), mesh=mesh, pipeline=pipe,
        opt_cfg=optim.AdamWConfig(lr=lr, warmup_steps=steps // 20,
                                  total_steps=steps),
        ckpt_dir=ckpt, ckpt_every=ckpt_every, microbatch=microbatch,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-1b", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized sibling config (default on CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        init_ranks(int(os.environ["RANK"]), world, "env://", device=dev)
    try:
        trainer = make_trainer(
            args.arch, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
            ckpt=args.ckpt, ckpt_every=args.ckpt_every, microbatch=args.microbatch,
            reduced=args.reduced, seed=args.seed, device=dev)
        hist = trainer.run(args.steps)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if hist:
        print(f"[train] {args.arch}: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}; stragglers: "
              f"{len(trainer.monitor.events)}")


if __name__ == "__main__":
    main()
