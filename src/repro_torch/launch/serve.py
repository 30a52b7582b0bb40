"""Serving launcher (port of ``repro.launch.serve``): batched prefill,
then greedy decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
        --batch 8 --prompt-len 128 --gen 64 [--quant-kv] [--reduced] \
        [--device cuda|cpu] [--seed 0] [--slo-decode-ms MS]

The device defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the reduced config, as the reference does on a CPU backend.
``generate`` is the work: ``main`` and ``chip_smoke.py`` both call it.
The cache is updated in place (the reference donates it), and the decode
loop reads nothing back: on the card it runs under
``torch.cuda.set_sync_debug_mode("error")``, so a host read in it
raises.  The tokens come to the host once, at the end; the times are
CUDA events on the card and the host clock on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ARCHS, get_config, reduce_config
from ..device import no_host_sync, resolve_device
from ..models import get_model
from ..obs import clock as obs_clock
from ..obs import health as obs_health
from . import steps as steps_mod


def _mark(dev):
    """A point on the device's timeline: a recorded CUDA event on the card,
    the host clock on the CPU (where every op has ended when it returns)."""
    if dev.type != "cuda":
        return obs_clock.now()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


def generate(model, params, prompts, gen: int, *, quant_kv: bool = False,
             prefix_embeds=None, encoder_embeds=None, forced=None,
             logits_out: list | None = None) -> dict:
    """Prefill ``prompts`` (B, P) and decode greedily to ``gen`` tokens each,
    with a float32 KV cache (int8 with ``quant_kv``) on the prompts' device.
    ``prefix_embeds`` (VLM) and ``encoder_embeds`` (Whisper's mel frames)
    go to the prefill.

    ``forced`` (B, gen - 1), if given, is fed to the decode steps in place
    of the greedy tokens (teacher forcing: two runs then decode the same
    sequence and their logits compare step by step).  ``logits_out``, if
    given, receives the (B, V) logits of the prefill and of each decode
    step.  Returns the tokens (a (B, gen) int32 numpy array) and the times:
    prefill ms, decode ms per token and tokens per second.
    """
    dev = prompts.device
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen, dtype=torch.float32, quant_kv=quant_kv,
                             device=dev)
    prefill = steps_mod.make_prefill_step(model)
    decode = steps_mod.make_decode_step(model, logits_out)
    batch = {"tokens": prompts}
    if prefix_embeds is not None:
        batch["prefix_embeds"] = prefix_embeds
    if encoder_embeds is not None:
        batch["encoder_embeds"] = encoder_embeds

    t0 = _mark(dev)
    logits, cache = prefill(params, cache, batch)
    tok = steps_mod.greedy(logits)
    t1 = _mark(dev)
    if logits_out is not None:
        logits_out.append(logits[:, -1])
    toks = [tok]
    with no_host_sync(dev):
        for t in range(gen - 1):
            feed = tok if forced is None else forced[:, t]
            tok, cache = decode(params, cache, {"tokens": feed[:, None]})
            toks.append(tok)
        t2 = _mark(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    decode_ms = _ms(t1, t2)
    return {"tokens": torch.stack(toks, dim=1).cpu().numpy(),
            "prefill_ms": _ms(t0, t1),
            "decode_ms_per_token": decode_ms / max(gen - 1, 1),
            "tokens_per_s": B * (gen - 1) / max(decode_ms / 1e3, 1e-9)}


def serve(arch: str = "qwen1.5-4b", *, batch: int = 4, prompt_len: int = 64,
          gen: int = 32, quant_kv: bool = False, reduced: bool = False,
          device="cuda", seed: int = 0) -> dict:
    """The launcher's run: ``arch``'s config (reduced with ``reduced`` or
    on the CPU), random parameters from ``seed``, prompts from ``seed + 1``,
    VLM prefix embeddings (0.02 x normal) or Whisper's encoder frames
    (0.1 x normal) from ``seed + 2``, then ``generate``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced or dev.type == "cpu":
        cfg = reduce_config(cfg)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed + 1))
    kw = {}
    if cfg.num_prefix_tokens:
        kw["prefix_embeds"] = 0.02 * torch.randn(
            (batch, cfg.num_prefix_tokens, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed + 2))
    if cfg.enc_layers:
        kw["encoder_embeds"] = 0.1 * torch.randn(
            (batch, cfg.enc_seq, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed + 2))
    out = generate(model, params, prompts, gen, quant_kv=quant_kv, **kw)
    return {"cfg": cfg, **out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--quant-kv", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo-decode-ms", type=float, default=None,
                    help="per-token decode latency SLO; the run is judged "
                         "by obs.health and exits non-zero on breach")
    args = ap.parse_args(argv)

    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                quant_kv=args.quant_kv, reduced=args.reduced, device=args.device,
                seed=args.seed)
    B, P, G = args.batch, args.prompt_len, args.gen
    ms_per_tok = res["decode_ms_per_token"]
    print(f"[serve] {args.arch}: batch={B} prompt={P} gen={G} "
          f"kv={'int8' if args.quant_kv else 'native'} device={args.device}")
    print(f"  prefill {res['prefill_ms']:.1f} ms | "
          f"decode {ms_per_tok:.2f} ms/tok | "
          f"throughput {res['tokens_per_s']:.1f} tok/s")

    if args.slo_decode_ms is not None:
        # obs.health takes any hand-built gauge view; here the per-token
        # decode latency is the one SLO a launcher run can witness.
        policy = obs_health.SLOPolicy(latency_p99_s=args.slo_decode_ms / 1e3,
                                      min_events=1)
        report = obs_health.evaluate(
            policy, {"completed": G - 1, "latency_p99_s": ms_per_tok / 1e3})
        print(f"  [health] {report['status']}: decode {ms_per_tok:.2f} "
              f"ms/tok vs SLO {args.slo_decode_ms:.2f} ms/tok")
        if report["status"] != "ok":
            raise SystemExit(1)


if __name__ == "__main__":
    main()
