"""Time the paged decode attention at the benchmark cells' shapes on one card.

    python3 tools/paged_attention_times.py [--splits 1,2,3,4,6,8]
        [--stages 48,64,96] [--seed 33]

Needs one NVIDIA card (sm_90a) and runs from a checkout of the repo.
For each cell's decode shape (``olmoe-reasoning``: 48 slots, 16 x 16
heads, 256-page tables, contexts 128-4096; ``qwen3-chat-planned``: 32
slots, 32 q / 8 kv heads, 288-page tables, contexts 256-4608, 11 slots
empty; D = 128, pages of 16, bf16, the tuner's tiles) it checks
``fused_attention_paged`` against its plain walk, then prints one JSON
line: the device ms of the wrapper (the paged kernel, its merge and the
normalisation) at the split count ``paged_splits`` picks, of the paged
kernel and merge alone at each split count of ``--splits``, of the
gather path the wrapper replaced (both pools gathered through the page
table and copied into the contiguous layout, the positions, the
unpaged partial kernel), of the plain walk (once, host clock around a
synchronised call), and the bound: the live keys' k and v, q and o,
each moved once at 3.35 TB/s.  With ``--stages`` also the kernel at
each ring stage size (bf16 keys, ``PAGED_STAGE_KEYS``) and split
count.  ``--seed`` draws the contexts and the data.  Prints the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS, D = 16, 128
# slots, q heads, kv heads, table width, context range, empty slots
CELLS = {"olmoe-reasoning": (48, 16, 16, 256, 128, 4096, 0),
         "qwen3-chat-planned": (32, 32, 8, 288, 256, 4608, 11)}


def batch(cell: str, seed: int = 33):
    """(q, k_pages, v_pages, table, lengths) of a cell's decode step:
    contexts log-uniform over the cell's range, pages shuffled."""
    b, hq, hkv, mp, lo, hi, empty = CELLS[cell]
    rng = np.random.RandomState(seed)
    lengths = np.exp(rng.uniform(np.log(lo), np.log(hi), b)).astype(np.int32)
    lengths[rng.permutation(b)[:empty]] = 0
    need = -(-lengths // PS)
    table = np.full((b, mp), -1, np.int32)
    table[np.arange(mp)[None, :] < need[:, None]] = \
        rng.permutation(int(need.sum())) + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp, vp = (torch.randn(int(need.sum()) + 1, hkv, PS, D, generator=g,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn(b, hq, 1, D, generator=g,
                    device="cuda").to(torch.bfloat16)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="1,2,3,4,6,8,12")
    ap.add_argument("--stages", default="")
    ap.add_argument("--seed", type=int, default=33)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the timing runs on the card")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as C
    from repro_torch.core import api
    from repro_torch.dist.ring_dispatch import finalize_partials
    from repro_torch.kernels import attention as A
    from repro_torch.serving import kv_pages as KP
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for cell in CELLS:
        b, hq, hkv, mp = CELLS[cell][:4]
        q, kp, vp, table, lengths = batch(cell, args.seed)
        p = api.fuse_attention_paged(1, mp * PS, D, D, page_size=PS,
                                     heads=hq, kv_heads=hkv, batch=b,
                                     dtype="bfloat16").params
        bq, bkv, smem = A._check_paged(q, kp, vp, table, lengths, p.bq,
                                       p.bkv, mp * PS)
        tiles = mp * PS // bkv
        picked = A.paged_splits(b, hkv, 1, tiles, bkv, smem)
        scale = D ** -0.5

        def wrapper():
            return A.fused_attention_paged(q, kp, vp, table, lengths, bq=bq,
                                           bkv=bkv)

        got = wrapper()
        o, _, l_run = A.fused_attention_paged_plain(
            q, kp, vp, table, lengths, bkv, 0, scale, picked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A.fused_attention_paged_plain(q, kp, vp, table, lengths, bkv, 0,
                                      scale, picked)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        want = (o / torch.where(l_run == 0.0, 1.0, l_run)).to(q.dtype)
        torch.testing.assert_close(got, want, **C.TOL[torch.bfloat16])

        def gathered():
            k, v = (KP.gather_pages(t, table) for t in (kp, vp))
            kv_pos = KP.paged_kv_positions(table, PS, invalid=A.INVALID_POS)
            q_pos = lengths[:, None] - 1
            o, _, l_run = A.fused_attention_partial(
                q, k, v, kv_pos, q_pos, bq=bq, bkv=bkv, causal=True)
            return finalize_partials(o, l_run, q.dtype)

        torch.testing.assert_close(gathered(), got, **C.TOL[torch.bfloat16])
        by_splits = {}
        for s in (int(x) for x in args.splits.split(",")):
            if s <= tiles:
                by_splits[s] = C._time_ms(
                    lambda s=s: A._launch_paged(q, kp, vp, table, lengths, 0,
                                                bq, bkv, 0, scale, smem, s))
        by_stage = {}
        for sk in (int(x) for x in args.stages.split(",") if x):
            # the ring's stage size is the module's constant: swept here
            # by setting it, restored after
            keep, A.PAGED_STAGE_KEYS = A.PAGED_STAGE_KEYS, sk
            try:
                _, _, sm = A._check_paged(q, kp, vp, table, lengths, bq,
                                          bkv, mp * PS)
                for s in (int(x) for x in args.splits.split(",")):
                    run = (lambda s=s, sm=sm: A._launch_paged(
                        q, kp, vp, table, lengths, 0, bq, bkv, 0, scale, sm,
                        s))
                    o2, _, l2 = run()
                    torch.testing.assert_close(
                        (o2 / torch.where(l2 == 0.0, 1.0, l2)).to(q.dtype),
                        got, **C.TOL[torch.bfloat16])
                    by_stage[f"{sk}/{s}"] = C._time_ms(run)
            finally:
                A.PAGED_STAGE_KEYS = keep
        live = int(lengths.sum())
        nbytes = (2 * hkv * D * live + 2 * int((lengths > 0).sum()) * hq * D) * 2
        print(json.dumps({
            "cell": cell, "seed": args.seed, "tiles": [bq, bkv], "smem": smem,
            "live_keys": live, "table_keys": b * mp * PS,
            "wrapper_splits": picked, "wrapper_ms": C._time_ms(wrapper),
            "kernel_ms_by_splits": by_splits,
            "kernel_ms_by_stage_keys_splits": by_stage,
            "gather_path_ms": C._time_ms(gathered), "plain_ms": plain_ms,
            "bound_ms": 1e3 * nbytes / 3.35e12}))


if __name__ == "__main__":
    main()
