"""Dry run of the LM steps over the production layouts (port of
``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell:

  1. PROOF run: the full-depth step runs once on ``meta`` tensors (shapes,
     no storage, nothing computed) at one rank's batch: the global batch
     over the ``pod`` x ``data`` axes when the batch rule shards it
     (``launch.shardings``), else the whole batch.  ``OpCounter`` keeps
     its live bytes.  This takes the place of the reference's compile: it
     shows that the step's shapes hold at production depth and what one
     rank holds at its peak.

  2. COST probes: the step is counted at two small depths (L1, L2) and
     extrapolated affinely in L, as the reference does.  The port has no
     scan hiding its layers; the probes keep the count short (a
     ``prefill_32k`` layer runs 64 x 64 attention chunk pairs in Python).
     Per chip FLOPs and bytes are one rank's counts over the ``model``
     axis: an even split.  The port executes no tensor parallelism, so
     they are the bound of the layout, not of a program that runs on it.

  3. Collectives, from the layout's specs: the least traffic its batch
     axes need.  A parameter sharded over a batch axis (``fsdp`` ->
     ``data``) is gathered once per use: in the forward pass, and in
     training again for the recomputation (remat) and the backward pass;
     a gradient is reduce-scattered onto the shards of its parameter and
     all-reduced over the batch axes the parameter is not sharded on.
     The ``model`` axis's activation collectives are left out, so the
     collective term is a lower bound, as every roofline term is.

The roofline reads the H100 SXM table ``launch.mesh.HW`` (data-sheet
peaks at 700 W); the layouts are the reference's meshes
(``make_production_mesh``), so specs and state bytes equal the
reference's.  The counter sees every attention chunk, so no correction is
added; ``_attention_correction`` stays as the analytic count of the
attention products, which the counts are checked against.

Usage:
  python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
"""
import argparse
import dataclasses
import json
import math
import os
import traceback

import numpy as np
import torch

from .. import optim
from ..configs import ARCHS, get_config
from ..models import SHAPES, get_model, shape_applicable, token_specs
from ..models import common as mcommon
from ..models.common import mesh_shape
from ..obs import clock as obs_clock
from . import shardings as shd
from . import steps as steps_mod
from .mesh import HW, make_production_mesh
from .op_analysis import (OpCounter, collective_stats, roofline_terms, tensor_bytes,
                          tensors_of)

BATCH_AXES = ("pod", "data")


def _pairs(tree, specs):
    """(leaf, spec) of a state tree and its spec tree, leaf by leaf."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    else:
        yield tree, specs


def _sharded_nbytes(tree, shardings, mesh) -> int:
    """Per-device bytes of a state tree under its specs on ``mesh``.  The
    cache's host ``int`` position counts as the reference's int32
    scalar."""
    axes = mesh_shape(mesh)
    total = 0
    for arr, spec in _pairs(tree, shardings):
        if isinstance(arr, int):
            total += 4
            continue
        n = math.prod(arr.shape) if arr.shape else 1
        n_shards = 1
        for dim_spec in spec:
            if dim_spec is None:
                continue
            for a in ((dim_spec,) if isinstance(dim_spec, str) else dim_spec):
                n_shards *= axes[a]
        total += n * arr.element_size() // max(n_shards, 1)
    return total


def _with_layers(cfg, L: int):
    """Config with depth L, keeping family structure consistent."""
    kw = {"num_layers": L}
    if cfg.family == "hybrid":
        kw["global_attn_layers"] = (0, L // 2, L - 1)
    if cfg.enc_layers:
        kw["enc_layers"] = L
    return dataclasses.replace(cfg, **kw)


def _rank_batch(spec, mesh, B: int) -> int:
    """One rank's batch under the batch dim's ``spec``."""
    axes = mesh_shape(mesh)
    dim = spec[0]
    if dim is None:
        return B
    return B // math.prod(axes[a] for a in ((dim,) if isinstance(dim, str) else dim))


def _build(cfg, shape, mesh, *, quant_kv, microbatch, kv_model_axis=False,
           kv_seq_model=False):
    """(step, args, state_bytes) for one step kind: the step function, its
    arguments on ``meta`` at one rank's batch (parameters, optimizer state
    or cache, inputs), and the state's per-device bytes under the
    layout's specs (the global state, as the reference counts it)."""
    model = get_model(cfg)
    params_abs = model.abstract_params()
    p_shard = shd.param_shardings(model, mesh)
    specs = token_specs(cfg, shape)
    in_shard = shd.batch_shardings(specs, mesh)
    B = shape.global_batch
    B_loc = _rank_batch(in_shard["tokens"], mesh, B)
    inputs = {k: torch.empty((B_loc, *v.shape[1:]), dtype=v.dtype, device="meta")
              for k, v in specs.items()}

    if shape.kind == "train":
        opt_cfg = optim.AdamWConfig()
        opt_abs = optim.init_state(params_abs)
        o_shard = shd.opt_state_shardings(p_shard, mesh)
        step = steps_mod.make_train_step(model, opt_cfg, microbatch=microbatch)
        args = (params_abs, opt_abs, inputs)
        state = _sharded_nbytes(params_abs, p_shard, mesh) + _sharded_nbytes(
            opt_abs, o_shard, mesh)
    else:
        def cache(batch):
            return model.init_cache(batch, shape.seq_len, dtype=torch.bfloat16,
                                    quant_kv=quant_kv, device="meta")

        cache_abs = cache(B)
        seq_ok = shape.kind == "decode"
        c_shard = shd.cache_shardings(cache_abs, mesh, seq_axis_ok=seq_ok,
                                      kv_model_axis=kv_model_axis,
                                      kv_seq_model=kv_seq_model)
        if seq_ok:
            mcommon.set_rules(seq="data")
        step = (steps_mod.make_decode_step(model) if shape.kind == "decode"
                else steps_mod.make_prefill_step(model))
        args = (params_abs, cache_abs if B_loc == B else cache(B_loc), inputs)
        state = _sharded_nbytes(params_abs, p_shard, mesh) + _sharded_nbytes(
            cache_abs, c_shard, mesh)
    return step, args, state


def _distinct_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in tensors_of(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def _run(step, args, *, live_only: bool = False) -> dict:
    """Run ``step(*args)`` once under an ``OpCounter``.  Returns its counts
    (``ops``, ``flops``, ``bytes``, ``flops_by_op``), the arguments' and
    the outputs' bytes, and the peak: the arguments plus the largest sum
    of storages the step held alive at once."""
    counter = OpCounter(live_only=live_only)
    with counter:
        out = step(*args)
    arg_bytes = _distinct_bytes(args)
    return {"ops": counter.ops, "flops": counter.flops, "bytes": counter.bytes,
            "flops_by_op": dict(counter.flops_by_op),
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _distinct_bytes(out),
            "peak_live_bytes": arg_bytes + counter.peak}


def _collectives(cfg, shape, mesh, params_abs, p_shard):
    """The least collective traffic of the layout's batch axes (module
    docstring, 3) as ``CollectiveStats``."""
    axes = mesh_shape(mesh)
    batch = [a for a in BATCH_AXES if a in axes]
    train = shape.kind == "train"
    uses = (3 if cfg.remat != "none" else 2) if train else 1
    records = []
    for arr, spec in _pairs(params_abs, p_shard):
        on = set()
        model_shards = 1
        for dim_spec in spec:
            for a in ((dim_spec,) if isinstance(dim_spec, str) else dim_spec or ()):
                if a in batch:
                    on.add(a)
                else:
                    model_shards *= axes[a]
        full = tensor_bytes(arr) // model_shards        # gathered, per device
        g_on = math.prod(axes[a] for a in on)
        g_off = math.prod(axes[a] for a in batch if a not in on)
        if g_on > 1:
            records += [("all-gather", full, g_on)] * uses
        if train and g_on > 1:
            records.append(("reduce-scatter", full // g_on, g_on))
        if train and g_off > 1:
            records.append(("all-reduce", full // g_on, g_off))
    return collective_stats(records, group_size=16)


def _count_costs(cfg, shape, mesh, *, quant_kv, microbatch,
                 kv_model_axis=False, kv_seq_model=False) -> dict:
    """Count once; return flops / bytes / collective stats (per device)."""
    step, args, _ = _build(cfg, shape, mesh, quant_kv=quant_kv,
                           microbatch=microbatch, kv_model_axis=kv_model_axis,
                           kv_seq_model=kv_seq_model)
    counts = _run(step, args)
    model = get_model(cfg)
    coll = _collectives(cfg, shape, mesh, model.abstract_params(),
                        shd.param_shardings(model, mesh))
    split = mesh_shape(mesh).get("model", 1)
    return {
        "flops": counts["flops"] / split,
        "bytes": counts["bytes"] / split,
        "wire": float(coll.wire_bytes),
        "counts": coll.counts,
        "ops": counts["ops"],
    }


def _extrapolate(c1, c2, L1, L2, L):
    out = {}
    for k in ("flops", "bytes", "wire"):
        slope = (c2[k] - c1[k]) / (L2 - L1)
        out[k] = c1[k] + slope * (L - L1)
    counts = {}
    for kind in set(c1["counts"]) | set(c2["counts"]):
        a, b = c1["counts"].get(kind, 0), c2["counts"].get(kind, 0)
        counts[kind] = int(round(a + (b - a) / (L2 - L1) * (L - L1)))
    out["counts"] = counts
    return out


def _attention_correction(cfg, shape, *, once_counted: bool = True) -> tuple[float, float]:
    """Exact analytic FLOPs/bytes of the chunked-attention einsums: full
    (Sq x Skv) rectangles with masking (the 2x causal overcompute is
    included -- it is what the code executes).  Returns GLOBAL (flops,
    bytes).  With ``once_counted`` (the reference's correction) it leaves
    out the one chunk pair that XLA's cost analysis counts of a scan
    body; without, it is the whole count, which the port's counter sees.

    decode shapes need no correction (single-pass attention, fully counted).
    """
    if shape.kind == "decode" or cfg.family == "ssm":
        return 0.0, 0.0
    B = shape.global_batch
    chunk = cfg.attn_chunk
    mult_f = 4.0 if shape.kind == "train" else 1.0   # fwd+remat+2x bwd
    mult_b = 3.0 if shape.kind == "train" else 1.0

    def one(Sq, Skv, H, KH, hd, n_layers):
        nq = max(-(-Sq // chunk), 1)
        nk = max(-(-Skv // chunk), 1)
        discount = 1.0 - 1.0 / (nq * nk) if once_counted else 1.0
        f = 4.0 * B * H * Sq * Skv * hd * discount
        by = (nq * B * Skv * KH * hd * 8.0 + B * Sq * H * hd * 12.0) * discount
        return n_layers * f * mult_f, n_layers * by * mult_b

    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = shape.seq_len + cfg.num_meta_tokens + cfg.num_prefix_tokens
    fl, by = 0.0, 0.0
    if cfg.family == "encdec":
        f1, b1 = one(cfg.enc_seq, cfg.enc_seq, H, KH, hd, cfg.enc_layers)
        f2, b2 = one(shape.seq_len, shape.seq_len, H, KH, hd, cfg.num_layers)
        f3, b3 = one(shape.seq_len, cfg.enc_seq, H, KH, hd, cfg.num_layers)
        fl, by = f1 + f2 + f3, b1 + b2 + b3
    elif H:
        fl, by = one(S, S, H, KH, hd, cfg.num_layers)
    return fl, by


def _activation_bytes(cfg, shape, mesh) -> int:
    """Analytic per-device activation estimate (the reference's memory
    model, unchanged)."""
    axes = mesh_shape(mesh)
    bsh = np.prod([axes.get(a, 1) for a in ("pod", "data")])
    B_loc = max(shape.global_batch // int(bsh), 1)
    d, L = cfg.d_model, cfg.num_layers
    S = shape.seq_len if shape.kind != "decode" else 1
    V_loc = cfg.padded_vocab // axes.get("model", 1)
    carry = B_loc * S * d * 2                     # bf16 residual per layer
    if shape.kind == "train":
        saved = L * carry                          # remat=full: carries only
        work = 8 * B_loc * S * d * 4               # attn/mlp working set f32
        logits = 2 * B_loc * S * V_loc * 4         # CE fwd+bwd f32
        return int(saved + work + logits)
    work = 6 * B_loc * S * d * 4
    logits = B_loc * 1 * V_loc * 4
    return int(work + logits + carry)


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.axis_sizes)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             quant_kv: bool = False, microbatch: int = 1,
             extra_rules: dict | None = None, probes: bool = True,
             overrides: dict | None = None,
             kv_model_axis: bool = False,
             kv_seq_model: bool = False) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
        "quant_kv": quant_kv,
    }
    if not ok:
        cell["skipped"] = reason
        return cell

    n_chips = mesh.size
    kw = dict(quant_kv=quant_kv, microbatch=microbatch,
              kv_model_axis=kv_model_axis, kv_seq_model=kv_seq_model)
    mcommon.reset_rules()
    try:
        if extra_rules:
            mcommon.set_rules(**extra_rules)

        # 1. PROOF run: full depth on meta, one rank's batch, live bytes.
        t0 = obs_clock.now()
        step, args, state_bytes = _build(cfg, shape, mesh, **kw)
        proof = _run(step, args, live_only=True)
        trace_s = obs_clock.now() - t0
        del step, args

        # 2. COST probes: small depths, affine extrapolation in L.
        L = cfg.num_layers
        if probes:
            if cfg.family == "hybrid":
                L1, L2 = 5, 9
            else:
                L1, L2 = 2, 4
            cfg1 = dataclasses.replace(_with_layers(cfg, L1), scan_layers=False)
            cfg2 = dataclasses.replace(_with_layers(cfg, L2), scan_layers=False)
            c1 = _count_costs(cfg1, shape, mesh, **kw)
            c2 = _count_costs(cfg2, shape, mesh, **kw)
            est = _extrapolate(c1, c2, L1, L2, L)
            ops = c1["ops"] + (c2["ops"] - c1["ops"]) / (L2 - L1) * (L - L1)
        else:
            est = _count_costs(cfg, shape, mesh, **kw)
            ops = est["ops"]
    finally:
        mcommon.reset_rules()

    attn_f, _ = _attention_correction(cfg, shape, once_counted=False)
    flops, hbm_bytes, wire = est["flops"], est["bytes"], est["wire"]
    terms = roofline_terms(flops=flops, hbm_bytes=hbm_bytes, wire_bytes=wire,
                           n_chips=n_chips, hw=HW)

    N_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * N_active * tokens
    model_flops_per_chip = model_flops / n_chips

    act_bytes = _activation_bytes(cfg, shape, mesh)
    per_dev = state_bytes + act_bytes
    cell.update({
        "trace_seconds": round(trace_s, 1),
        "n_chips": n_chips,
        "counted_flops_per_chip": flops,
        "counted_bytes_per_chip": hbm_bytes,
        "counted_ops_one_rank": ops,
        "attn_flops_analytic_per_chip": attn_f / n_chips,
        "collective_wire_bytes_per_chip": wire,
        "collective_counts": est["counts"],
        "roofline": terms,
        "model_flops_total": model_flops,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flop_ratio": (model_flops_per_chip / flops) if flops else None,
        "memory_analysis": {
            "argument_size_in_bytes": proof["argument_size_in_bytes"],
            "output_size_in_bytes": proof["output_size_in_bytes"],
            "peak_live_bytes_one_rank": proof["peak_live_bytes"],
        },
        "state_bytes_per_device": state_bytes,
        "activation_bytes_per_device_est": act_bytes,
        "peak_bytes_per_device_est": per_dev,
        "fits_hbm": bool(per_dev < HW["hbm_bytes"]),
        "mfu_upper_bound": (
            model_flops_per_chip / HW["peak_flops_bf16"]
        ) / max(terms["bound_step_s"], 1e-30),
    })
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quant-kv", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_cell(arch, shape, multi_pod=mp,
                                 quant_kv=args.quant_kv,
                                 microbatch=args.microbatch,
                                 probes=not args.no_probes)
                    if "skipped" in r:
                        print(f"[skip] {tag}: {r['skipped']}", flush=True)
                    else:
                        print(
                            f"[ok]   {tag}: trace={r['trace_seconds']}s "
                            f"flops/chip={r['counted_flops_per_chip']:.3e} "
                            f"dominant={r['roofline']['dominant']} "
                            f"fits={r['fits_hbm']}", flush=True)
                except Exception as e:
                    r = {"arch": arch, "shape": shape,
                         "mesh": "2x16x16" if mp else "16x16",
                         "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()[-2000:]}
                    print(f"[FAIL] {tag}: {r['error']}", flush=True)
                results.append(r)
                # write incrementally so long sweeps are restartable
                if args.out:
                    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    if args.out:
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
