"""Find the highest arrival rate an open-loop cell sustains.

    python3 portbench/sweep.py --workload <cell> --seconds <s> \
        --seeds <n> ... --rates 1.5 1.75 2 2.25

One process: the cell's weights and engine once, then, rate by rate in
ascending order, a warm-up of the padded prompt lengths that rate's
traffic draws and not yet warmed, and a window of ``--seconds`` of the
cell's own traffic at that rate for each seed, the engine emptied
between windows.  The backlog is the number of requests that have
arrived and not finished (queued or in a slot), read after every step
over the whole window.  A window sustains its rate when the backlog
does not grow: its mean over the window's last quarter is at most 1.2
times its mean over the second quarter, plus 2 (the first quarter
fills the empty engine).  A rate is sustained when every seed's window
sustains it; the sweep stops after the first rate that is not.  The rate the cell's traffic file
fixes is 0.8 of the highest rate sustained; the sweep is recorded in
PERF.md.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

import run as R  # noqa: E402

DEVICE = "cuda"


def quarter_means(samples: list, t0: float, seconds: float) -> list:
    """Mean backlog in each quarter of the window, from (time, backlog)
    samples."""
    out = []
    for q in range(4):
        a, b = t0 + q * seconds / 4, t0 + (q + 1) * seconds / 4
        vals = [n for t, n in samples if a < t <= b]
        out.append(float(np.mean(vals)) if vals else 0.0)
    return out


def sustains(quarters: list) -> bool:
    return quarters[3] <= 1.2 * quarters[1] + 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    R.environment()
    from portbench.harness import drive, measure, spec, weights
    from portbench.harness import traffic as TR
    cell = spec.load_cell(args.workload)
    if cell.traffic["loop"] != "open":
        raise SystemExit("the sweep is for open-loop cells")
    m = cell.config["model"]
    params = weights.make(cell.arch, m, args.seeds[0], DEVICE)
    engine = drive.build_engine(cell, params, DEVICE)
    warmed = set()
    best = None
    for rate in sorted(args.rates):
        mix = dict(cell.traffic, rate_per_s=rate)
        c = dataclasses.replace(cell, traffic=mix)
        by_seed = {seed: TR.generate(mix, m["vocab"], seed, args.seconds,
                                     engine.n_ctx) for seed in args.seeds}
        new = sorted({n for reqs in by_seed.values()
                      for n in TR.padded_lengths(reqs, engine.page_size)}
                     - warmed)
        t = time.perf_counter()
        if new:
            drive.warm(engine, new, m["vocab"], DEVICE)
            warmed |= set(new)
        print(f"[sweep] rate {rate}: warmed {len(new)} more padded "
              f"lengths in {time.perf_counter() - t:.1f} s "
              f"({time.perf_counter() - T_PROCESS:.1f} s since start)",
              flush=True)
        ok = True
        for seed, reqs in by_seed.items():
            tracker, served = drive._Tracker(engine), []
            backlog = []
            orig = engine.step

            def step():
                res = orig()
                backlog.append((time.perf_counter(), len(engine.queue)
                                + sum(s is not None for s in engine.slots)))
                return res
            engine.step = step
            t0, t1, steps, steps_all, _ = drive.run_window(
                c, engine, reqs, args.seconds, False, DEVICE, tracker,
                served)
            engine.step = orig
            run = drive.Run(c, m, args.seconds, t0, t1, steps, steps_all,
                            served, {}, {}, set(), offered=list(reqs))
            quarters = quarter_means(backlog, t0, args.seconds)
            row = {"rate_per_s": rate, "seed": seed,
                   "arrived": len(served),
                   "finished": sum(1 for s in served
                                   if s.outcome is not None),
                   "backlog_by_quarter": quarters,
                   "backlog_max": max((n for _, n in backlog), default=0),
                   "ttft_p50_ms": measure.ttft_p50_ms(run),
                   "ttft_p95_ms": measure.ttft_p95_ms(run),
                   "itl_p50_ms": measure.itl_p50_ms(run),
                   "itl_p95_ms": measure.itl_p95_ms(run),
                   "decode_ms": measure.decode_step_ms(run),
                   "sustained": sustains(quarters)}
            ok &= row["sustained"]
            print("[sweep] " + json.dumps(row), flush=True)
            engine.drain(deadline=0.0)
            drive._sync(DEVICE)
            engine.reset()
        if not ok:
            break
        best = rate
    print(f"[sweep] highest sustained on every seed {best} req/s; 0.8 of "
          f"it {0.8 * best if best else None}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
