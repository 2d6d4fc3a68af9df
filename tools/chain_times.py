"""Time the chain machine's kernels, and the normalised attention, at the
tuner's picks on one card, for one or more source trees in turn.

    python3 tools/chain_times.py [--sweep] [SRC ...]

Needs one NVIDIA card (sm_90a) and runs from a checkout of the repo.
For each SRC (a checkout's ``src`` directory; default this checkout's),
in the order given and in a fresh process each, it times with CUDA-graph
replay (``chip_smoke._adaptive_ms``) the gated bf16 MLP at qwen3-8b's
width at M = 4, 144 and 4096 (``api.fuse_mlp_chain``), the GEMM chain at
Table II G12 (bf16) and G1 (f32) (``api.fuse_gemm_chain``), the
three-GEMM chain at CHAIN3 (bf16) and the normalised attention at
qwen3-8b's forward (B=2, S=2048, bf16, causal) and Table III S2 (f32)
(``api.fuse_attention``), each at the tuner's tiles through the public
entry points only, and prints one JSON line per SRC.  Each tree
builds its own kernels into its own ``kernels/build``.  Give a tree
twice (parent, change, change, parent) to see the spread between runs
of one tree.  ``--sweep`` adds, for each tree, ``chip_smoke.py``'s G12
phase (``chain_time_phase``) over every flat tile of a small grid (bm x
bn x bk) the wrapper takes, with the wrapper's split; that needs a tree
whose ``check_gemm_chain`` returns (tiles, split, bytes), as this
checkout's does.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(src: str, sweep: bool) -> None:
    """Time every case with the ``repro_torch`` of ``src``."""
    sys.path[:0] = [os.path.abspath(src), ROOT]
    tag = hashlib.sha256(os.path.abspath(src).encode()).hexdigest()[:8]
    os.environ["REPRO_TORCH_CACHE_DIR"] = os.path.join(
        ROOT, ".cache", f"schedules-{tag}")
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.kernels import gemm_chain3 as G3

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-8b")
    out = {"src": src}
    for label, m in C.MLP_SHAPES.items():
        (a, wu, wd, wg), kw = C._mlp_case(cfg, m, torch.bfloat16, True,
                                          "silu", 99)
        tk = api.fuse_mlp_chain(m, cfg.d_ff, cfg.d_model, dtype="bfloat16")
        if not torch.isfinite(tk(a, wu, wd, wg=wg)).all():
            raise RuntimeError(f"MLP {label}: non-finite output")
        out[f"mlp {label}"] = C._adaptive_ms(
            lambda: tk(a, wu, wd, wg=wg), reps=3)
        out[f"mlp {label} tiles"] = kw
        del a, wu, wd, wg
    for name, dt in (("G12", torch.bfloat16), ("G1", torch.float32)):
        b, m, n, k, h = C.CHAINS[name]
        tk = api.fuse_gemm_chain(m, n, k, h, batch=b, dtype=C._dtname(dt))
        xs = C._randn([(b, m, k), (b, k, n), (b, n, h)], dt, 97, scaled=True)
        if not torch.isfinite(tk(*xs)).all():
            raise RuntimeError(f"{name}: non-finite output")
        out[f"{name} {C._dtname(dt)}"] = C._adaptive_ms(lambda: tk(*xs))
        out[f"{name} {C._dtname(dt)} tiles"] = tk.params.as_kwargs()
    b, m, n, k, h, g = C.CHAIN3
    tiles = C._chain3_tiles(torch.bfloat16)
    xs = C._randn([(b, m, k), (b, k, n), (b, n, h), (b, h, g)],
                  torch.bfloat16, 96, scaled=True)
    if not torch.isfinite(G3.fused_gemm_chain3(*xs, **tiles)).all():
        raise RuntimeError("CHAIN3: non-finite output")
    out["chain3 bf16"] = C._adaptive_ms(
        lambda: G3.fused_gemm_chain3(*xs, **tiles))
    out["chain3 bf16 tiles"] = tiles
    b, s, hq, hkv, d = (C.FORWARD["batch"], C.FORWARD["seq"], cfg.n_heads,
                        cfg.n_kv_heads, cfg.dh)
    h2, m2, n2, k2, _ = C.ATTN_TABLE_III["S2"]
    for label, (bb, h, g, m, n, dd, dt, causal) in (
            ("attention forward bf16", (b, hq, hkv, s, s, d, torch.bfloat16,
                                        True)),
            ("attention S2 f32", (1, h2, h2, m2, n2, k2, torch.float32,
                                  False))):
        tk = api.fuse_attention(m, n, dd, dd, heads=h, batch=bb,
                                dtype=C._dtname(dt), causal=causal)
        xs = C._randn([(bb, h, m, dd), (bb, g, n, dd), (bb, g, n, dd)], dt,
                      98)
        with torch.inference_mode():
            if not torch.isfinite(tk(*xs)).all():
                raise RuntimeError(f"{label}: non-finite output")
            out[label] = C._adaptive_ms(lambda: tk(*xs))
        out[f"{label} tiles"] = tk.params.as_kwargs()
    print(json.dumps(out), flush=True)
    if sweep:
        C.chain_time_phase("G12", torch.bfloat16, sweep=g12_grid(C))


def g12_grid(C) -> list:
    """Every flat G12 tile of a small grid (bm x bn x bk) the wrapper
    takes in bf16."""
    from repro_torch.kernels import gemm_chain as G

    b, m, n, k, h = C.CHAINS["G12"]
    meta = [torch.empty(s, dtype=torch.bfloat16, device="meta")
            for s in ((b, m, k), (b, k, n), (b, n, h))]
    grid = []
    for bm in (16, 32, 64, 128):
        for bn in (16, 64, 128, 256):
            for bk in (32, 64, 128):
                try:
                    G.check_gemm_chain(*meta, bm, bn, bk, h, "flat")
                except ValueError:
                    continue
                grid.append(dict(bm=bm, bn=bn, bk=bk, bh=h, style="flat"))
    return grid


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the timing runs on the card")
    if argv[:1] == ["--worker"]:
        worker(argv[2], argv[1] == "--sweep")
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    mode = "--sweep" if argv[:1] == ["--sweep"] else "--cases"
    for src in argv[mode == "--sweep":] or [os.path.join(ROOT, "src")]:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", mode, src], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
