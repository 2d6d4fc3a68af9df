"""Whole runs of the harness at CPU size: the look for a card skipped,
the rest of a run driven, on the port's plain paths.  A sound run is
correct; a run whose timed path is broken underneath is not; no run
loads JAX or the JAX package.  ``sm90``: a cell's run on the card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run as R
from portbench.harness import spec

HERE = Path(__file__).resolve().parent
DATA = HERE / "data"
ROOT = HERE.parents[1]
#: each tiny configuration stands for a cell's and is held to its limits
CASES = {"tiny-moe": ("tiny-closed", "olmoe-reasoning"),
         "tiny-dense": ("tiny-open", "qwen3-chat-planned")}
SEED = 3_000_000_007


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def tiny_cell(name: str) -> spec.Cell:
    mix, cell = CASES[name]
    b = _json(ROOT / "BENCHMARK.json")
    e2e = [m["name"] for m in b["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m["name"] for m in b["per_layer"]
             if cell in m.get("workloads", [cell])]
    units = {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
    config = _json(DATA / f"{name}.json")
    return spec.Cell(name, config, _json(DATA / f"{mix}.json"),
                     _json(ROOT / "portbench" / "limits" / f"{cell}.json"),
                     e2e, layer, units, spec.architecture(config))


def measure(name: str, trace: bool = False, seconds: float = 1.5):
    import time
    return R.measure(tiny_cell(name), SEED, seconds, trace, "cpu",
                     time.perf_counter())[0]


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "schedules"))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace):
    res = measure(name, trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["mean_logit_gap"]["value"] <= 1e-4
    cell = tiny_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) <= set(want)
    if not trace:
        assert set(res["metrics"]) == set(want)


def _altered_token(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    orig = ServingEngine._outputs

    def outputs(self, logits):
        host, lg = orig(self, logits)
        return (host + 1) % logits.shape[-1], lg
    monkeypatch.setattr(ServingEngine, "_outputs", outputs)


def _state_unchanged(monkeypatch):
    """A decode step that leaves the cache as it found it."""
    from repro_torch.serving import kv_pages as KP
    orig = KP.scatter_pages

    def scatter(pages, phys, off, values):
        return pages if values.shape[1] == 1 else orig(pages, phys, off,
                                                       values)
    monkeypatch.setattr(KP, "scatter_pages", scatter)


def _half_batch(monkeypatch):
    """A decode step that computes half of its slots and hands the other
    half the first half's answers."""
    from repro_torch.models.lm import LM
    orig = LM.decode_step_paged

    def step(self, params, cache, tokens, positions, table):
        logits, cache = orig(self, params, cache, tokens, positions, table)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), cache
    monkeypatch.setattr(LM, "decode_step_paged", step)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = measure(name)
    assert not res["correct"]
    gap = res["checks"]["mean_logit_gap"]
    assert gap["value"] is None or gap["value"] > gap["limit"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, "
        f"{str(HERE)!r}]\n"
        "import test_portbench_run as T\n"
        "T.measure('tiny-moe', seconds=0.5)\n"
        "from portbench import run as R\n"
        "print('FORBIDDEN', R.forbidden_modules())\n"
        "print('TOP', sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ), timeout=600,
                         check=True).stdout
    assert "FORBIDDEN []" in out
    top = json.loads(out.split("TOP ")[1].strip().replace("'", '"'))
    assert "repro_torch" in top
    assert not {"jax", "jaxlib", "flax", "repro"} & set(top)


@pytest.mark.sm90
def test_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "olmoe-reasoning", "--seed", str(SEED), "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]


@pytest.mark.sm90
@pytest.mark.parametrize("cell", ["olmoe-reasoning", "qwen3-chat-planned",
                                  "qwen3-reasoning-planned"])
def test_control_is_not_correct_at_the_cells_size(cell):
    """The float8 control put in the program's place reads past the
    cell's limit, and the program within it, on one seed at the cell's
    own size (``control.py``; PERF.md holds the readings of many)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "control.py"),
         "--workload", cell, "--seconds", "51", "--seeds", str(SEED),
         "--control-seeds", str(SEED)], capture_output=True, text=True,
        timeout=1800, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("[reading]")]
    reading = json.loads(line[-1].split(" ", 1)[1])
    limit = _json(ROOT / "portbench" / "limits" / f"{cell}.json")
    assert reading["program"]["mean"] <= limit["mean_logit_gap"]
    assert reading["control"]["mean"] > limit["mean_logit_gap"]
