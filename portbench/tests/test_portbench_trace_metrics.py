"""The readers of the serving engine's phase counters, worked by hand on
synthetic windows: each new metric's arithmetic, ``prefill.span_mfu``'s
refusal when the step log and the engine count prompts apart, and
nothing read from a program without the counters."""
import json
from pathlib import Path

import pytest

from portbench.harness import spec
from portbench.harness.drive import Run, StepRec

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
NEW = ("queue.wait_ms", "prefill.span_mfu", "kv.gather_live")


def _config(name: str) -> dict:
    with open(CONFIGS / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def _run(stats: dict, prefills=(), config="qwen3-8b.planned") -> Run:
    c = _config(config)
    cell = spec.Cell("synthetic", c, {}, {}, [], [], {},
                     spec.architecture(c))
    steps = [StepRec(0.0, 0.1, [n], [5], 1) for n in prefills]
    steps += [StepRec(0.1, 0.2, [], [5, 6], 2)]
    return Run(cell, c["model"], 1.0, 0.0, 1.0, steps, steps, [], stats,
               {}, set())


STATS = {"decode_steps": 40, "prefills": 2, "queue_wait_s": 0.3,
         "schedule_s": 0.04, "prefill_s": 0.5, "decode_stage_s": 0.02,
         "decode_launch_s": 0.28, "decode_wait_s": 3.0, "book_s": 0.06,
         "page_slot_steps": 40 * 2000,
         "gathered_page_steps": 40 * 32 * 288}


def test_each_reader_on_a_synthetic_window():
    run = _run(dict(STATS), prefills=(1000, 3000))
    read = {m: spec.reader(m)(run) for m in NEW}
    assert read["queue.wait_ms"] == pytest.approx(150.0)
    assert read["kv.gather_live"] == pytest.approx(100.0 * 2000 / 9216)
    m = run.model
    arch = run.cell.arch
    flops = arch.prefill_flops(m, 1000) + arch.prefill_flops(m, 3000)
    assert read["prefill.span_mfu"] == pytest.approx(
        100.0 * flops / 0.5 / 989e12)


def test_span_mfu_wants_the_prompts_the_engine_prefilled():
    # a preempted request's recompute: the engine prefilled three
    # prompts, the step log saw two
    assert spec.reader("prefill.span_mfu")(
        _run(dict(STATS, prefills=3), prefills=(1000, 3000))) is None
    assert spec.reader("prefill.span_mfu")(
        _run(dict(STATS), prefills=())) is None


def test_a_window_with_nothing_to_divide_reads_nothing():
    run = _run(dict(STATS, decode_steps=0, prefills=0, page_slot_steps=0,
                    gathered_page_steps=0))
    assert all(spec.reader(m)(run) is None for m in NEW)


def test_a_program_without_the_counters_reads_nothing():
    old = {k: STATS[k] for k in ("decode_steps", "prefills",
                                 "page_slot_steps")}
    run = _run(old, prefills=(1000, 3000))
    got = {m: spec.reader(m)(run) for m in NEW}
    assert all(v is None for v in got.values()), got


@pytest.mark.parametrize("metric", NEW)
def test_entry_names_a_cell_that_reports_what_it_moves(metric):
    b = json.loads((CONFIGS.parents[1] / "BENCHMARK.json").read_text())
    (entry,) = [m for m in b["per_layer"] if m["name"] == metric]
    assert entry["source"] == "program_counter"
    moved = next(m for m in b["end_to_end"] if m["name"] == entry["moves"])
    assert set(entry["workloads"]) <= set(moved["workloads"])


@pytest.mark.parametrize("config,mix,cell", [
    ("tiny-moe", "tiny-closed", "olmoe-reasoning"),
    ("tiny-dense", "tiny-open", "qwen3-chat-planned")])
def test_a_traced_run_reads_every_new_metric_of_its_cell(
        tmp_path, monkeypatch, config, mix, cell):
    """A traced run at CPU size on the port's plain paths (the times are
    the CPU's: this checks the readers find their counters, nothing
    else)."""
    import time

    from portbench import run as R
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    data = Path(__file__).resolve().parent / "data"
    real = spec.load_cell(cell)
    c = json.loads((data / f"{config}.json").read_text())
    tiny = spec.Cell(cell, c, json.loads((data / f"{mix}.json").read_text()),
                     real.limits, real.end_to_end, real.per_layer,
                     real.units, spec.architecture(c))
    res = R.measure(tiny, 3_000_000_019, 1.5, True, "cpu",
                    time.perf_counter())[0]
    want = [m for m in NEW if m in real.per_layer]
    got = {m: res["metrics"].get(m, {}).get("value") for m in want}
    assert want and all(v is not None and v >= 0 for v in got.values()), got
