"""Time the MLP kernel over tiles and ring sizes on one card.

    python3 tools/mlp_tile_sweep.py

Needs one NVIDIA card (sm_90a) and runs from a checkout of the repo.
At qwen3-8b's full width (K = H = 4096, N = 12288, bf16, gated silu,
random weights from a seed) and the decode (M = 4) and prefill
(M = 144) rows of ``chip_smoke.py`` it launches ``fused_mlp_chain``'s
kernel at every tile of a small grid that the kernel takes (flat class,
the split ``perf_model.mlp_splits`` gives), with the cp.async ring sized
for each of a few byte targets (``perf_model.MLP_RING_BYTES``), checks
each launch against the plain version with the same split, and prints
one JSON line per shape with the device ms of each tile beside the
tuner's pick.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, M, bm, bn, bk) grids; the ring targets in bytes in flight
SHAPES = [("decode", 4, (4,), (64, 96, 128, 192), (32, 64, 128)),
          ("prefill", 144, (48, 144), (32, 64, 96, 128), (32, 64))]
RING_BYTES = (65536, 131072)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs on the card")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    os.environ.setdefault("REPRO_TORCH_CACHE_DIR",
                          os.path.join(ROOT, ".cache", "schedules"))
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.core import perf_model as P
    from repro_torch.kernels import gemm_chain as G
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    cfg = get_config("qwen3-8b")
    n, k, h = cfg.d_ff, cfg.d_model, cfg.d_model
    defaults = (P.MLP_RING_BYTES, P.MLP_MAX_STAGES)
    for label, m, bms, bns, bks in SHAPES:
        (a, wu, wd, wg), pick = C._mlp_case(cfg, m, torch.bfloat16, True,
                                            "silu", 99)
        ms = {}
        for ring, bm, bn, bk in itertools.product(RING_BYTES, bms, bns,
                                                  bks):
            P.MLP_RING_BYTES = ring
            P.MLP_MAX_STAGES = 14
            P._mlp_splits_scalar.cache_clear()
            if not P.mlp_tiles_ok(bm, bn, n, 2, 2):
                continue
            splits, per = P.mlp_splits(1, m, n, k, h, bm, bn, bk, h, 2, 2,
                                       True)
            if P.mlp_smem_bytes(bm, bn, bk, h, 2, 2, True, per) \
                    > P.H100.smem_per_block:
                continue
            run = (lambda bm=bm, bn=bn, bk=bk, s=splits: G._launch(
                a, wu, wd, wg, "silu", bm, bn, bk, h, s))
            got = run()
            want = G.fused_mlp_chain_plain(a, wu, wd, wg, "silu", bn, splits)
            torch.testing.assert_close(got, want, **C.TOL[torch.bfloat16])
            stages = int(P.mlp_ring(bm, bn, bk, True)[0])
            ms[f"ring {ring // 1024}K x{stages} {bm}/{bn}/{bk} "
               f"x{splits}"] = C._adaptive_ms(run, reps=2)
        P.MLP_RING_BYTES, P.MLP_MAX_STAGES = defaults
        P._mlp_splits_scalar.cache_clear()
        print(json.dumps({"shape": label, "M": m, "tuner": pick,
                          "ms": ms}))


if __name__ == "__main__":
    main()
