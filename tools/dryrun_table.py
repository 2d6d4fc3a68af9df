"""The dry run's records as a markdown table, one row a cell.

    python3 tools/dryrun_table.py [DIR]

Reads the JSON records ``python -m repro_torch.launch.dryrun --all
--mesh both --out DIR`` wrote (default ``results/dryrun``) and prints,
for each cell that ran, the three roofline terms in seconds (compute,
memory, collective), the dominant one, the peak a rank in GiB and
``useful_ratio`` on the 16 x 16 and the 2 x 16 x 16 mesh; then the
cells skipped and the cells that recorded an error, with the error's
first line.  Every figure is priced under the records' hardware
descriptor (``H100``): none is measured.
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
    ran, skipped, failed = [], [], []
    for (arch, shape), by_mesh in sorted(cells.items()):
        recs = [by_mesh.get(m, {}) for m in ("single", "multi")]
        if all("roofline" in r for r in recs):
            ran.append(f"| {arch} {shape} | " + " | ".join(
                _terms(r) for r in recs) + " |")
        elif any("skipped" in r for r in recs):
            skipped.append(f"{arch} {shape}")
        else:
            errs = {r.get("error", "missing").split(";")[0][:120]
                    for r in recs if "roofline" not in r}
            failed.append(f"{arch} {shape}: {' / '.join(sorted(errs))}")
    print("| Cell | 16x16: compute / memory / collective s | dominant | "
          "peak GiB | useful | 2x16x16: compute / memory / collective s | "
          "dominant | peak GiB | useful |")
    print("|---|---|---|---|---|---|---|---|---|")
    print("\n".join(ran))
    n = sum(len(v) for v in cells.values())
    print(f"\n{n} records: {2 * len(ran)} ran, {2 * len(skipped)} skipped, "
          f"{2 * len(failed)} recorded an error.")
    print("Skipped: " + ", ".join(skipped) + ".")
    print("Errors:\n" + "\n".join(f"- {f}" for f in failed))


if __name__ == "__main__":
    main()
