"""MCFuser quickstart: tune a fused kernel for an MBCI chain, inspect
the chosen schedule, and check it against the unfused oracle.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The counterpart of the JAX package's ``examples/quickstart.py``: a
memory-bound GEMM chain (paper Table II, G1-style) and Bert-Base
attention (Table III, S2), each tuned under the H100 descriptor and run
through its CUDA kernel on the card (``--device cpu``: the kernels'
plain versions).
"""
from __future__ import annotations

import argparse

import torch

from ..core import api
from ..core.perf_model import H100, estimate, t_comp, t_mem
from ..kernels.ref import gemm_chain_ref, gqa_attention_ref


def _randn(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def main(argv=None) -> dict:
    """Runs both examples; returns {name: (max |err|, max |oracle|)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    errors = {}

    # --- 1. a memory-bound GEMM chain (paper Table II, G1-style) -------
    print("=== fused GEMM chain: E = (A@B)@D, M=512 N=256 K=H=64 ===")
    tk = api.fuse_gemm_chain(M=512, N=256, K=64, H=64, batch=1)
    s = tk.report.best
    print(f"tuned schedule : {s.sub_expr()}  grid={s.grid}  "
          f"kernel={tk.params}")
    print(f"tile sizes     : {s.tile_sizes}")
    print(f"est. H100 time : {estimate(s, H100)*1e6:.2f} us "
          f"(mem {t_mem(s, H100)*1e6:.2f} / comp {t_comp(s, H100)*1e6:.2f})")
    print(f"tuning took    : {tk.tuning_seconds:.2f}s, "
          f"{tk.report.n_measured} measured of "
          f"{tk.report.n_candidates} candidates ({tk.source})")
    a = _randn((1, 512, 64), 0, dev)
    b = _randn((1, 64, 256), 1, dev)
    d = _randn((1, 256, 64), 2, dev)
    want = gemm_chain_ref(a, b, d)
    err = float((tk(a, b, d) - want).abs().max())
    errors["gemm_chain"] = (err, float(want.abs().max()))
    print(f"max |err| vs oracle: {err:.2e} (max |oracle| "
          f"{errors['gemm_chain'][1]:.3g})")

    # --- 2. fused attention (paper Table III, S2 = Bert-Base) ----------
    print("\n=== fused attention: Bert-Base (12 heads, 512x512x64) ===")
    tk = api.fuse_attention(M=512, N=512, K=64, H=64, heads=12)
    s = tk.report.best
    print(f"tuned blocks   : bq={s.tile_sizes['m']} bkv={s.tile_sizes['n']}"
          f"  online-softmax rescale: {s.needs_rescale}")
    print(f"est. H100 time : {estimate(s, H100)*1e6:.2f} us")
    q = _randn((1, 12, 512, 64), 0, dev)
    k = _randn((1, 12, 512, 64), 1, dev)
    v = _randn((1, 12, 512, 64), 2, dev)
    with torch.no_grad():
        want = gqa_attention_ref(q, k, v)
        err = float((tk(q, k, v) - want).abs().max())
    errors["attention"] = (err, float(want.abs().max()))
    print(f"max |err| vs oracle: {err:.2e} (max |oracle| "
          f"{errors['attention'][1]:.3g})")
    return errors


if __name__ == "__main__":
    main()
