"""The dry run's records as a markdown table, one row a cell.

    python3 tools/dryrun_table.py [DIR]

Reads the JSON records ``python -m repro_torch.launch.dryrun --all
--out DIR`` wrote (default ``results/dryrun``) and prints, for each
cell that ran, the three roofline terms in seconds (compute, memory,
collective), the dominant one, the peak a rank in GiB and
``useful_ratio`` on the 16 x 16 and the 2 x 16 x 16 mesh, one row a
cell (records of ``--mesh both``), or on the one mesh the records hold,
one row an arch and one column a shape (``--mesh single`` or
``multi``); then the cells skipped and the cells that recorded an
error, with the error's first line.  Every figure is priced under the
records' hardware descriptor (``H100``): none is measured.
"""
from __future__ import annotations

import glob
import json
import os
import sys


def _terms(rec: dict) -> str:
    r = rec["roofline"]
    return (f"{r['compute_s']:.3g} / {r['memory_s']:.3g} / "
            f"{r['collective_s']:.3g} | {r['dominant']} | "
            f"{rec['memory']['peak_per_device_gb']:.3g} | "
            f"{r['useful_ratio']:.3f}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else os.path.join("results", "dryrun")
    cells: dict = {}
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        arch, shape, mesh = os.path.basename(path)[:-5].split("__")
        with open(path) as f:
            cells.setdefault((arch, shape), {})[mesh] = json.load(f)
    meshes = [m for m in ("single", "multi")
              if any(m in by_mesh for by_mesh in cells.values())]
    ran, skipped, failed = [], [], []
    for (arch, shape), by_mesh in sorted(cells.items()):
        recs = [by_mesh.get(m, {}) for m in meshes]
        if all("roofline" in r for r in recs):
            ran.append(f"| {arch} {shape} | " + " | ".join(
                _terms(r) for r in recs) + " |")
        elif any("skipped" in r for r in recs):
            skipped.append(f"{arch} {shape}")
        else:
            errs = {r.get("error", "missing").split(";")[0][:120]
                    for r in recs if "roofline" not in r}
            failed.append(f"{arch} {shape}: {' / '.join(sorted(errs))}")
    names = {"single": "16x16", "multi": "2x16x16"}
    if len(meshes) == 1:
        shapes = sorted({shape for _, shape in cells})
        print(f"{names[meshes[0]]}: compute / memory / collective s, "
              f"dominant, peak GiB, useful")
        print("| Arch | " + " | ".join(shapes) + " |")
        print("|---|" + "---|" * len(shapes))
        for arch in sorted({arch for arch, _ in cells}):
            row = []
            for shape in shapes:
                rec = cells.get((arch, shape), {}).get(meshes[0], {})
                row.append(_terms(rec).replace(" | ", ", ")
                           if "roofline" in rec else
                           "skipped" if "skipped" in rec else "error")
            print(f"| {arch} | " + " | ".join(row) + " |")
    else:
        print("| Cell | " + " | ".join(
            f"{names[m]}: compute / memory / collective s | dominant | "
            f"peak GiB | useful" for m in meshes) + " |")
        print("|---|" + "---|---|---|---|" * len(meshes))
        print("\n".join(ran))
    n = sum(len(v) for v in cells.values())
    k = len(meshes)
    print(f"\n{n} records: {k * len(ran)} ran, {k * len(skipped)} skipped, "
          f"{k * len(failed)} recorded an error.")
    print("Skipped: " + ", ".join(skipped) + ".")
    print("Errors:\n" + "\n".join(f"- {f}" for f in failed))


if __name__ == "__main__":
    main()
