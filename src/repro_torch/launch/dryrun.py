"""The multi-pod dry run: trace every (arch x shape x mesh) cell's step as
rank 0 of the production mesh on the ``meta`` device, and price it.

The JAX package lowers and compiles each cell's jitted step on 512
forced host devices and reads XLA's memory and cost analyses.  Here
each cell's step runs eagerly on ``meta`` tensors (nothing is
computed or allocated) as rank 0 of a ``DryMesh``
(``launch.mesh.make_production_mesh``), whose collectives move nothing,
under ``launch.op_cost.OpCost``: the op stream gives the flops, bytes
and peak memory of one rank, the collectives their traffic, and
``launch.analysis`` the roofline terms under ``core.perf_model.H100``.
It needs no card and starts no world, by design.

For each cell:
    model   = build_model(cfg, Runtime(rules, mesh, remat=...), "meta")
    params  = local_specs(model.abstract_params(), model.param_specs())
    train:    make_train_step(model, AdamW)(params, opt_state, batch)
    prefill:  make_prefill_step(model)(params, cache, batch)
    decode:   make_decode_step(model)(params, cache, batch)

Rank 0 holds its blocks of the params, optimizer state and cache, and
the whole batch: the entry points take whole tensors and each rank
takes its rows (the record's ``convention``).  A record has the JAX
package's keys, ``trace_s`` in place of ``lower_s`` and ``compile_s``;
its ``_xla`` figures are the plain step's, op by op (the unfused
attention interior), beside the bytes with the interior replaced by
the tuned kernel's.  The step traced is the
plain path, as the JAX package's dry run traces its model without
``kernel_ops``.  Records are written as each cell ends (JSON a cell),
so a sweep resumes; a failure is recorded with its traceback, never
swallowed.

Usage (on any host):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

from ..configs import ALIASES, ARCHS, SHAPES, cell_applicable, get_config
from ..core.perf_model import H100
from ..dist.sharding import Rules, mesh_shape
from ..models.lm import Runtime
from . import analysis, steps
from .mesh import make_production_mesh
from .op_cost import Cost, OpCost

CONVENTION = ("rank 0: its blocks of the params, optimizer state and "
              "cache; the batch whole, as the entry points take it")


def cell_rules(kind: str, multi_pod: bool, regime: str = "auto",
               dist_decode: bool = False) -> tuple[str, Rules]:
    """(regime, Rules) of a cell, the JAX package's choice: ``tp`` for a
    decode cell, Megatron-SP (``tp+sp``) otherwise; ``zero3`` puts the
    batch over every dim and gathers every weight whole (no tensor
    parallelism) — multi-pod, the batch over the pod and data dims and
    the sequence over the model dim (sequence parallelism without
    tensor parallelism, where the model dim divides a cell's
    sequence)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    if regime == "auto":
        regime = "tp" if kind == "decode" else "tp+sp"
    if regime == "zero3":
        rules = Rules(data=dp, model="model",
                      batch_axes=dp + (("model",) if not multi_pod else ()),
                      tp=None, seq="model" if multi_pod else None)
    elif regime == "tp":
        rules = Rules(data=dp, model="model", tp="model", seq=None,
                      fsdp=not dist_decode)
    else:
        rules = Rules(data=dp, model="model", tp="model", seq="model")
    return regime, rules


def trace_step(model, shape, cfg):
    """(OpCost, record of memory) of one ``shape`` step of ``model``
    (under a mesh) on ``meta`` tensors: this rank's blocks of its params
    (and AdamW state, or cache) and ``input_specs``' whole batch."""
    mesh = model.rt.mesh
    params = steps.local_specs(model.abstract_params(), model.param_specs(),
                               mesh)
    batch = steps.input_specs(cfg, shape)
    cost = OpCost()
    if shape.kind == "train":
        opt = steps.default_optimizer()
        state = opt.abstract_state(params)
        fn = steps.make_train_step(model, opt)
        args = (params, state, batch)
    else:
        cache = steps.local_specs(steps.abstract_cache(model, cfg, shape),
                                  model.cache_specs(shape.batch), mesh)
        fn = (steps.make_prefill_step(model) if shape.kind == "prefill"
              else steps.make_decode_step(model))
        args = (params, cache, batch)
    with cost:
        arg_bytes = cost.hold(*args)
        out = fn(*args)
        alias = cost.held_bytes(out)
        out_bytes = cost.live
    peak = cost.peak
    return cost, {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": peak - arg_bytes,
        "alias_bytes": alias,
        "peak_per_device_gb": round(peak / 2**30, 3),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             remat_policy: str = "full", regime: str = "auto",
             dist_decode: bool = False, extra: Optional[dict] = None, *,
             mesh=None, smoke: bool = False, shape=None,
             hw=H100) -> dict:
    """Trace and price one cell; returns its record.  ``mesh`` (a
    ``DryMesh``), ``smoke`` (the SMOKE config) and ``shape`` (a
    ``ShapeCell``) replace the production mesh, the FULL config and the
    named cell, for small checks."""
    cfg = get_config(arch, smoke=smoke)
    shape = shape or SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    dims = mesh_shape(mesh)
    n_dev = 1
    for v in dims.values():
        n_dev *= v
    regime, rules = cell_rules(shape.kind, "pod" in dims, regime,
                               dist_decode)
    rt = Runtime(rules=rules, mesh=mesh,
                 remat=(shape.kind == "train" and remat_policy != "none"),
                 remat_policy=("dots" if remat_policy == "dots" else None),
                 dist_decode_attn=dist_decode,
                 bkv=2048 if shape.kind == "prefill" else 512)

    t0 = time.perf_counter()
    model = steps.build_model(cfg, rt, device="meta")
    cost, memory = trace_step(model, shape, cfg)
    t_trace = time.perf_counter() - t0

    total, coll = cost.total, cost.collectives
    mf = analysis.model_flops(cfg, shape, n_dev)
    attn_regimes: dict = {}
    attn_kernel_bytes, n_attn = analysis.kernelized_attention_bytes(
        cfg, shape, n_dev, mesh=mesh, rules=rules, regime_log=attn_regimes,
        hw=hw)
    bytes_plain = total.bytes
    if shape.kind == "decode":
        # one query row: no attention interior a kernel would keep
        bytes_kernelized = bytes_plain
    else:
        bytes_kernelized = cost.rest.bytes + min(attn_kernel_bytes,
                                                 cost.attn.bytes)
    kernelized = Cost(total.flops, bytes_kernelized)
    roof = analysis.roofline_terms(kernelized, coll, mf, hw)
    dims_txt = "x".join(str(v) for v in dims.values())
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": dims_txt, "n_devices": n_dev, "regime": regime,
        "remat": remat_policy if shape.kind == "train" else "none",
        "convention": CONVENTION,
        "trace_s": round(t_trace, 1),
        "n_ops": cost.n_ops,
        "memory": memory,
        "collectives": coll.as_dict(),
        "attention": {
            "interior_bytes_xla": cost.attn.bytes,
            "kernelized_bytes": attn_kernel_bytes,
            "n_instances": n_attn,
            "regimes": attn_regimes,   # {"MxN": "spatial" | "ring"}
        },
        "planner": analysis.planner_chain_report(cfg, shape, mesh=mesh,
                                                 rules=rules, hw=hw),
        "roofline": {
            "flops_per_device": total.flops,
            "matmul_flops_per_device": total.mm_flops,
            "bytes_per_device": bytes_kernelized,
            "bytes_per_device_xla": bytes_plain,
            "collective_traffic": coll.traffic_bytes,
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "memory_s_xla": bytes_plain / hw.hbm_bw,
            "collective_s": roof.collective_s,
            "dominant": roof.dominant,
            "model_flops_per_device": mf,
            "useful_ratio": roof.useful_ratio,
        },
        "hw": hw.name,
    }
    if extra:
        rec.update(extra)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ALIASES) + ARCHS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", choices=("full", "dots", "none"),
                    default="full")
    ap.add_argument("--regime", choices=("auto", "zero3", "tp+sp", "tp"),
                    default="auto")
    ap.add_argument("--dist-decode", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have a JSON")
    args = ap.parse_args(argv)

    archs = ARCHS if args.all or not args.arch else [
        ALIASES.get(args.arch, args.arch)]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {tag}")
                    continue
                try:
                    rec = run_cell(arch, shape, multi,
                                   remat_policy=args.remat,
                                   regime=args.regime,
                                   dist_decode=args.dist_decode)
                    if "skipped" in rec:
                        n_skip += 1
                        print(f"[skip]   {tag}: {rec['skipped']}")
                    else:
                        n_ok += 1
                        r = rec["roofline"]
                        print(f"[ok]     {tag}: trace={rec['trace_s']}s "
                              f"mem={rec['memory']['peak_per_device_gb']}GB"
                              f" dom={r['dominant']} "
                              f"(c={r['compute_s']:.2e} "
                              f"m={r['memory_s']:.2e} "
                              f"coll={r['collective_s']:.2e})", flush=True)
                except Exception as e:  # noqa: BLE001 - record, sweep on
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi else "16x16",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL]   {tag}: {type(e).__name__}: "
                          f"{str(e)[:200]}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")


if __name__ == "__main__":
    main()
