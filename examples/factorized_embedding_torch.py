"""The paper's technique inside the LM, on the PyTorch port: CPD-factorized
embedding tables.

Trains two small LMs -- dense embedding vs rank-R CPD-factorized embedding
(cfg.cpd_embed_rank) -- and shows the parameter savings with comparable
loss.  The factor gradients are spMTTKRPs of the token batch (see
repro_torch/models/factorized_embed.py and its tests).

    PYTHONPATH=src python examples/factorized_embedding_torch.py [--device cuda|cpu]

The default device is the card.  ``main`` returns each run's numbers.
"""
import argparse
import dataclasses

from repro_torch import optim
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import make_host_mesh
from repro_torch.models import factorized_embed as fe
from repro_torch.models import get_model
from repro_torch.runtime import Trainer

STEPS = 60


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)

    base = dataclasses.replace(
        reduce_config(get_config("qwen1.5-4b")),
        vocab_size=8192, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
        num_layers=2, d_ff=256,
    )
    rows = []
    for label, cfg in [
        ("dense-embed", base),
        ("cpd-embed-r32", dataclasses.replace(base, cpd_embed_rank=32)),
    ]:
        model = get_model(cfg)
        n = sum(x.numel() for x in optim.adamw.tree_leaves(model.abstract_params()))
        pipe = TokenPipeline(cfg.vocab_size, batch=8, seq_len=64, seed=1)
        tr = Trainer(model, mesh=make_host_mesh(device=args.device), pipeline=pipe,
                     opt_cfg=optim.AdamWConfig(lr=2e-3, warmup_steps=5,
                                               total_steps=args.steps))
        h = tr.run(args.steps, log_every=1000)
        row = {"label": label, "params": n, "losses": [r["loss"] for r in h],
               "step_s": [r["time_s"] for r in h]}
        extra = ""
        if cfg.cpd_embed_rank:
            row["compression"] = fe.compression_ratio(cfg.padded_vocab, cfg.d_model,
                                                      cfg.cpd_embed_rank)
            extra = f" (table compression {row['compression']:.0f}x)"
        print(f"{label:14s}: params={n:>9,d} loss {h[0]['loss']:.3f} -> "
              f"{h[-1]['loss']:.3f}{extra}")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
