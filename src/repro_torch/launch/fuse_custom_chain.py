"""Define a CUSTOM MBCI chain (three back-to-back GEMMs), run it through
the full MCFuser pipeline — enumeration, DAG hoisting, pruning,
analytical search — and inspect what the tuner decided.

    PYTHONPATH=src python -m repro_torch.launch.fuse_custom_chain [--hw v5e]

The counterpart of the JAX package's ``examples/fuse_custom_chain.py``:
the same chain, ``gemm_chain3(M=1024, N=512, K=64, H=64, G=64)`` in
bf16, priced under the H100 descriptor (``--hw v5e``: the JAX package's
TPU descriptor, its numbers).  Under ``H100`` Rule 4's budget is the
shared memory of one thread block and the ridge the tensor cores' (in
place of VMEM and the MXU's).  Like the JAX example it launches no
kernel: ``--device`` (default ``cuda``) only has to exist.
"""
from __future__ import annotations

import argparse

import torch

from ..core.chain import gemm_chain3
from ..core.perf_model import (H100, V5E, GpuSpec, estimate, rule4_bytes,
                               t_comp, t_mem)
from ..core.pruning import PruneStats, generate_candidates
from ..core.search import heuristic_search
from ..core.tiling import enumerate_tilings, expr_repr

HW = {"h100": H100, "v5e": V5E}


def main(argv=None) -> dict:
    """Tunes the chain and prints the decision; returns it as a dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default="h100", choices=sorted(HW),
                    help="the descriptor the tuner prices under")
    ap.add_argument("--device", default="cuda",
                    help="cuda or cpu; nothing is launched")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not \
            torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device "
                           "cpu)")
    hw = HW[args.hw]
    gpu = isinstance(hw, GpuSpec)
    unit, ridge = (("tensor cores", "shared memory per block") if gpu
                   else ("MXU", "VMEM"))
    # G = ((A@B)@D)@F with small reduction dims -> MBCI
    ch = gemm_chain3(M=1024, N=512, K=64, H=64, G=64, dtype="bfloat16")
    ai = ch.arithmetic_intensity()
    print(f"chain: {ch.name}  loops={ch.loops}  descriptor: {hw.name}")
    print(f"arithmetic intensity (unfused): {ai:.1f} flops/byte "
          f"({unit} need {hw.peak_flops / hw.hbm_bw:.0f}+ to stay busy "
          f"-> memory-bound unfused)")

    exprs = enumerate_tilings(ch)
    print(f"\ntiling expressions: {len(exprs)} "
          f"(e.g. {expr_repr(exprs[0])}, {expr_repr(exprs[-1])})")

    stats = PruneStats()
    cands = generate_candidates(ch, hw, stats=stats)
    print(f"raw space {stats.n_total:,} -> kept {stats.n_kept:,} "
          f"(rule2 pruned {stats.n_rule2:,}, rule3 {stats.n_rule3:,}, "
          f"rule4 {stats.n_rule4:,})")

    rep = heuristic_search(ch, hw=hw, seed=0)
    s = rep.best
    on_chip = rule4_bytes(s, hw)
    est = estimate(s, hw)
    unfused = ch.io_bytes() / hw.hbm_bw
    print(f"\nbest schedule : {s.sub_expr()}  grid={s.grid}")
    print(f"tile sizes    : {s.tile_sizes}")
    print(f"{ridge:14s}: {on_chip / 2**10:.1f} KiB "
          f"(budget {hw.rule4_budget / 2**10:.0f} KiB)")
    print(f"est. time     : {est * 1e6:.2f} us  "
          f"[mem {t_mem(s, hw) * 1e6:.2f}, comp {t_comp(s, hw) * 1e6:.2f}]")
    print(f"unfused HBM floor alone would take {unfused * 1e6:.2f} us -> "
          f"fusion win >= {unfused / est:.1f}x")
    print(f"search measured {rep.n_measured}/{rep.n_candidates} candidates "
          f"in {rep.n_iterations} iterations")
    return {"hw": hw.name, "loops": dict(ch.loops),
            "arithmetic_intensity": ai, "n_exprs": len(exprs),
            "n_total": stats.n_total, "n_kept": stats.n_kept,
            "n_rule2": stats.n_rule2, "n_rule3": stats.n_rule3,
            "n_rule4": stats.n_rule4, "n_candidates": len(cands),
            "best": s.sub_expr(), "grid": tuple(s.grid),
            "tile_sizes": dict(s.tile_sizes), "on_chip_bytes": on_chip,
            "estimate_s": float(est), "unfused_s": unfused,
            "n_measured": rep.n_measured, "n_iterations": rep.n_iterations,
            "search_candidates": rep.n_candidates}


if __name__ == "__main__":
    main()
