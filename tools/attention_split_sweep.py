"""Time the partial attention kernel at every kv split count on one card.

    python3 tools/attention_split_sweep.py

Needs one NVIDIA card (sm_90a) and runs from a checkout of the repo.
At the decode shape of ``chip_smoke.py`` (B=4, Hq=32, Hkv=8, M=1,
D=128, bf16, per-request positions) it launches
``fused_attention_partial``'s kernel with each split count of a sweep
(``kernels.attention._launch``), checks each against the plain version
with the same split, and prints the device ms per call beside the
count the wrapper picks (``partial_splits``), one JSON line per shape.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (N, bkv, split counts); the tuner picks 1/16 at N=4096 and 1/160 at
# N=160, where 16-key tiles give the split something to cut
SHAPES = [(4096, 16, (1, 2, 4, 8, 9, 12, 16, 32, 64)),
          (4096, 128, (1, 2, 4, 8, 16, 32)),
          (160, 16, (1, 2, 3, 4, 5, 10))]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs on the card")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as C
    from repro_torch.kernels import attention as A
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    b, hq, hkv, d = 4, 32, 8, 128
    scale = d ** -0.5
    for n, bkv, counts in SHAPES:
        q, k, v, kv_pos, q_pos = C._attn_inputs(torch.bfloat16, b, hq, hkv,
                                                1, n, d, 99)
        bq, bkv, smem = A._check(q, k, v, kv_pos, q_pos, 1, bkv)
        ms = {}
        for s in counts:
            run = (lambda s=s: A._launch(q, k, v, kv_pos, q_pos, bq, bkv,
                                         True, 0, scale, smem, s))
            got = run()
            want = A.fused_attention_partial_plain(q, k, v, kv_pos, q_pos,
                                                   bkv, True, 0, scale, s)
            for x, w in zip(got, want):
                torch.testing.assert_close(x, w, **C.TOL[torch.bfloat16])
            ms[s] = C._time_ms(run)
        print(json.dumps({
            "N": n, "tiles": [bq, bkv], "smem": smem,
            "wrapper_splits": A.partial_splits(b, hkv, 1, n, bkv, smem)[0],
            "ms_by_splits": ms}))


if __name__ == "__main__":
    main()
