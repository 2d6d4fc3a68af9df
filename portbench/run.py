"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Measures ``repro_torch`` (never the JAX package) on the CUDA card the
process finds, and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number ``correct`` compared, beside its limit.
The same numbers are the last lines of standard error.  Without a card,
or with fewer cards than the cell asks for, it prints no result and
exits with 2.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment() -> None:
    """Every cache of the program inside the checkout, at fixed paths;
    no library loads JAX behind the port's back."""
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(CACHE / "schedules")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _num(x):
    return None if x is None or not math.isfinite(x) else x


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float) -> tuple:
    """One run of ``cell``: (result dict, lines for standard output)."""
    import torch

    from portbench.harness import check, drive, measure as M, spec
    from portbench.harness import trace as TRC
    torch.set_num_threads(4)
    run, params = drive.run_cell(cell, seed, seconds, trace, device,
                                 t_process)
    n = run.notes
    lines = [f"[setup] setup_s {n['setup_s']:.3f} ("
             + ", ".join(f"{k} {v:.3f}" for k, v in n["setup_parts"].items())
             + f"); prefill lengths warmed with the MLP kernel: "
             f"{len(run.fused_prefill)}"]
    lines.append(f"[window] searches {n['searched_in_window']}, tuned "
                 f"shapes {n['tuned_in_window']}, plans "
                 f"{n['planned_in_window']} made inside the window "
                 f"(want 0 each)")
    st, la = run.stats, run.launches
    layers = cell.arch.attention_layers(run.model)
    lines.append(
        f"[window] decode steps {st['decode_steps']}, prefills "
        f"{st['prefills']}; launches fused_attention_partial "
        f"{la.get('fused_attention_partial', 0)} (decode steps x "
        f"attention layers {st['decode_steps'] * layers}), fused_mlp_chain "
        f"{la.get('fused_mlp_chain', 0)}")
    lines.append(
        "[window] reliability: exec_tier " + str(n["exec_tier"]) + ", "
        + ", ".join(f"{k} {st.get(k, 0)}" for k in (
            "tier_demotions", "shadow_checks", "shadow_mismatches",
            "golden_probes", "golden_mismatches", "health_evictions",
            "preemptions"))
        + f", denylist records {n['deny_records']}")
    if "late_max_s" in n:
        lines.append(f"[window] generator lateness: max "
                     f"{n['late_max_s'] * 1e3:.3f} ms, p95 "
                     f"{n['late_p95_s'] * 1e3:.3f} ms")
    gaps, waits = M.itl_gaps(run), M.ttfts(run)
    for label, vals in (("inter-token gaps", gaps),
                        ("times to first token", waits)):
        if vals:
            lines.append(f"[window] {label} ({len(vals)}), ms: " + ", ".join(
                f"p{q} {M.percentile(vals, q) * 1e3:.3f}"
                for q in (50, 90, 95, 99)))
    finished = sum(1 for s in run.served if s.outcome is not None)
    lines.append(f"[window] requests {len(run.served)}, finished "
                 f"{finished}, in flight {n['in_flight_at_end']}, queued "
                 f"{n['queued_at_end']}; steps {len(run.steps)}")
    metrics = {}
    if trace:
        prof, span = run.trace
        run.trace = TRC.reduce(prof.events(), span, drive.SPANS)
        for name in cell.per_layer:
            v = spec.reader(name)(run)
            if v is not None:
                metrics[name] = v
    else:
        for name in cell.end_to_end:
            v = n["setup_s"] if name == "setup_s" else M.END_TO_END[name](run)
            if v is not None:
                metrics[name] = v
    metrics = {k: {"value": v, "unit": cell.units[k]}
               for k, v in metrics.items()}
    correct, compared, cnotes = check.judge(run, params, seed, cell.limits)
    lines.append(f"[check] judged {cnotes['judged_requests']} requests, "
                 f"{cnotes.get('judged_tokens', 0)} served tokens")
    del params
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": n["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": len(run.served),
              "failed": compared["failed_requests"][0],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": _num(v), "limit": lim}
                        for k, (v, lim) in compared.items()}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    import torch

    from portbench.harness import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA card(s), "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = measure(cell, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules loaded that the run must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
