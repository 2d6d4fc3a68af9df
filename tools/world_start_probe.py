"""What a gloo world and the kernels' build cost before any work runs.

    python3 tools/world_start_probe.py

Needs one NVIDIA card and the CUDA toolkit, and runs from a checkout of
the repo.  Prints the card's name and power limit, then: the seconds a
world of 1 and of 4 freshly spawned ranks (``launch.mesh.spawn``) takes
until each rank has imported torch, entered its function and run its
first CUDA op, and in all; the same worlds on the pool of rank
processes that ``chip_smoke.py`` keeps across its phases
(``chip_smoke._WorldPool``); the seconds a fresh process takes to
import ``chip_smoke``; and each kernel source's ``nvcc`` build with the
flags of ``kernels._build`` and with ``--split-compile=0`` left out, one
source at a time.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

T_START = time.time()
import torch  # noqa: E402

T_TORCH = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def _rank(rank):
    """Wall-clock marks of this rank: the module's import began, torch
    imported, the function entered, the first CUDA op done."""
    t_fn = time.time()
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    return dict(started=T_START, torch=T_TORCH, fn=t_fn, cuda=time.time(),
                x=float(x[0]))


def _world(run, world: int, label: str) -> None:
    t0 = time.time()
    marks = run(_rank, world, device="cuda")
    total = time.time() - t0
    by = {k: max(m[k] for m in marks) - t0
          for k in ("torch", "fn", "cuda")}
    print(f"{label} world of {world}: {total:.2f}s in all; the last rank "
          f"had imported torch at {by['torch']:.2f}s (the mark is stale "
          f"on a pooled rank), entered its function at {by['fn']:.2f}s, "
          f"run its first CUDA op at {by['cuda']:.2f}s", flush=True)


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn
    for world in (1, 4, 4):
        _world(spawn, world, "spawned")
    pool = chip_smoke._WorldPool(4)
    try:
        for world in (1, 4, 4):
            _world(pool.run, world, "pooled")
    finally:
        pool.close()
    t0 = time.time()
    subprocess.run([sys.executable, "-c", "import chip_smoke"], cwd=ROOT,
                   check=True)
    print(f"import chip_smoke in a fresh process: {time.time() - t0:.2f}s",
          flush=True)
    nvcc = _build._nvcc()
    flags = _build.NVCC_FLAGS
    with tempfile.TemporaryDirectory() as tmp:
        for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
            for label, fl in (("--split-compile=0", flags),
                              ("without it", [f for f in flags if not
                                              f.startswith("--split")])):
                t0 = time.time()
                proc = subprocess.run(
                    [nvcc, *fl, "-o", os.path.join(tmp, f"{name}.so"),
                     str(_build.CSRC / f"{name}.cu")],
                    capture_output=True, text=True)
                if proc.returncode:
                    raise RuntimeError(proc.stderr)
                print(f"nvcc {name}.cu {label}: {time.time() - t0:.2f}s",
                      flush=True)


if __name__ == "__main__":
    main()
