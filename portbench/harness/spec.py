"""A cell, found by name: its entry in ``BENCHMARK.json``, its
configuration file, its architecture (``portbench/reference/<name>.py``,
named by the file's ``"architecture"``, ``"decoder"`` where it names
none), its traffic mix (``portbench/traffic/<mix>.json``), its limits
(``portbench/limits/<cell>.json``) and the metrics it reports (the
per-layer readers are ``portbench/metrics/<metric>.py``).  A new cell,
mix, metric or architecture is a new file; no file here needs an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict                 # the configuration file
    traffic: dict                # the mix's parameters
    limits: dict                 # the numbers `correct` is held to
    end_to_end: list             # metric names, --trace 0
    per_layer: list              # metric names, --trace 1
    units: dict                  # metric name -> unit
    arch: ModuleType             # the configuration's architecture
    chips: int = 1


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _for(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def architecture(config: dict,
                 where: Path = PB / "reference") -> ModuleType:
    """The module of the architecture a configuration file names: its
    ``layout``, ``logits``, ``prefill_flops``, ``decode_flops`` and
    ``attention_layers``."""
    name = config.get("architecture", "decoder")
    path = where / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"architecture {name!r}: no file {path}")
    return _module(path, f"portbench_arch_{name}")


def load_cell(name: str, bench: Path = ROOT / "BENCHMARK.json",
              where: Path = PB / "reference") -> Cell:
    b = _json(bench)
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in {bench.name}")
    c = next(c for c in b["configs"] if c["name"] == w["config"])
    config = _json(ROOT / c["file"])
    units = {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
    return Cell(
        name=name, config=config,
        traffic=_json(PB / "traffic" / f"{w['traffic']}.json"),
        limits=_json(PB / "limits" / f"{name}.json"),
        end_to_end=[m["name"] for m in b["end_to_end"] if _for(m, name)],
        per_layer=[m["name"] for m in b["per_layer"] if _for(m, name)],
        units=units, arch=architecture(config, where),
        chips=int(w["chips"]))


def reader(metric: str, where: Path = PB / "metrics"):
    """The ``read(run)`` function of a per-layer metric's file."""
    return _module(where / f"{metric}.py",
                   f"portbench_metric_{metric.replace('.', '_')}").read
