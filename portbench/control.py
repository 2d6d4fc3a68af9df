"""Readings that set a cell's limit: the program's widest logit gap
over many seeds, and the control's, on the card at the cell's size.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

One process: for each seed the cell's weights, engine, warm-up and a
window of ``--seconds`` at the cell's own load, as ``run.py`` makes
them; then, with the program's state freed, the widest gap of the
served tokens on the judged sample (``harness.check``).  For each
control seed, also the control's reading on the same sample: the plain
reference with every weight product in float8 e4m3 (W8A8) put in the
program's place, the gap of the token it puts first at each served
position.  The limit (``portbench/limits/<cell>.json``) lies between
the two, and ``PERF.md`` records the readings.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    R.environment()
    import torch

    from portbench.harness import check, drive, spec
    cell = spec.load_cell(args.workload)
    budget = int(cell.limits["sample_tokens"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, params = drive.run_cell(cell, seed, args.seconds, False,
                                     "cuda", t0)
        picked = check.sample(run, seed, budget)
        got, ctl, rounded = check.gaps(
            cell.arch, run.model, params, picked,
            fp8_control=seed in args.control_seeds)
        print("[reading] " + json.dumps(
            {"seed": seed, "program": check.summary(got),
             "control": check.summary(ctl) if ctl is not None else None,
             "reference_rounded": check.summary(rounded),
             "judged_requests": len(picked),
             "finished": sum(1 for s in run.served
                             if s.outcome == "complete"),
             "seconds": time.perf_counter() - t0,
             "setup": run.notes["setup_parts"]}), flush=True)
        del run, params, picked
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
