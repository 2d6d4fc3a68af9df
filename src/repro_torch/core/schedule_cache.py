"""Persistent on-disk schedule cache — tuning survives process restarts.

``core.api._CACHE`` makes tuning free *within* a process; this module
makes it free *across* processes: every tuned schedule is persisted as
one JSON file under ``REPRO_TORCH_CACHE_DIR`` (default
``~/.cache/repro_torch/schedules``), keyed by the same signature the
in-memory cache uses plus a schema/model version hash.  The variables
differ from the JAX package's (``REPRO_CACHE_DIR``,
``REPRO_SCHEDULE_CACHE``) so TPU and GPU records never mix.  A serving
restart — or a dry-run sweep spawning hundreds of cells over the same
layer shapes — then rebuilds each fused kernel from disk in well under
10 ms instead of re-running ``heuristic_search``.

What is stored is the *search outcome*, not the kernel: the winning
tiling expression (serialized loop tree), tile sizes, and the report
telemetry.  Rebuilding runs one ``build_schedule`` + codegen pass, so
the warm path exercises exactly the code the cold path does after its
search — a cache hit can never produce a schedule the tuner would not
have produced.

Invalidation is structural: the key hash folds in ``SCHEMA_VERSION``
(this file's payload layout), ``perf_model.MODEL_VERSION`` (the
analytical model's semantics), and the hardware spec's constants, so
bumping any of them orphans old entries rather than misreading them.
Corrupt or truncated files are treated as misses (the tuner simply
runs) and are **quarantined** to ``<entry>.json.corrupt`` — evidence
preserved for debugging, while the retune writes a fresh entry at the
original path.  A schema-version mismatch is *not* corruption (it is a
valid record from an older layout) and is left in place.  Set
``REPRO_TORCH_SCHEDULE_CACHE=0`` to disable persistence entirely.

Writes are atomic (temp file + ``os.replace``) and serialized per-entry
with an advisory ``flock`` where the platform provides one, so
concurrent writers sharing one cache directory can race ``store`` on
the same key and readers still only ever see a complete record.  The
store also holds **denylist records** (``deny-<hash>.json``,
:func:`quarantine` / :func:`is_quarantined`): the circuit breaker in
:mod:`repro_torch.reliability.breaker` persists a failing schedule/plan
fingerprint there, *distinct from deletion* — the cached entry stays
warm, dispatch-level checks skip it, and a relaunch neither retries
the broken unit nor re-tunes it in a storm.

Entries also carry a **trial kind** — ``"analytic"`` (the search was
ranked and measured by the model alone, this container's default) or
``"measured"`` (top-k candidates were wall-clocked through a real
``measure_fn``, the on-card path).  The kind is a distinct component of
the entry path *and* is cross-checked in the payload, so an analytic
outcome can never satisfy a measured lookup or vice versa: measured
trials embed hardware truth the model cannot reproduce, and analytic
entries must not masquerade as it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile
from hashlib import sha256
from pathlib import Path
from typing import Iterator, Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: locking is advisory
    fcntl = None

from .perf_model import MODEL_VERSION, GpuSpec, TpuSpec
from .tiling import Loop, Scope

# Payload layout version: bump when the JSON record's fields change.
# v2: records carry a "trial" kind ("analytic" | "measured") that is
# also a key component — the two populations can never collide.
SCHEMA_VERSION = 2

TRIAL_KINDS = ("analytic", "measured")

_ENV_DIR = "REPRO_TORCH_CACHE_DIR"
_ENV_ENABLE = "REPRO_TORCH_SCHEDULE_CACHE"
_ENTRY_NAME = re.compile(r"[0-9a-f]{32}\.json")
_DENY_NAME = re.compile(r"deny-[0-9a-f]{32}\.json")
CORRUPT_SUFFIX = ".corrupt"


def enabled() -> bool:
    return os.environ.get(_ENV_ENABLE, "1") != "0"


def cache_dir() -> Path:
    root = os.environ.get(_ENV_DIR)
    if root:
        return Path(root)
    return Path.home() / ".cache" / "repro_torch" / "schedules"


def model_fingerprint(hw: "TpuSpec | GpuSpec") -> str:
    """Hash of everything that can silently change a tuned outcome."""
    payload = json.dumps(
        [SCHEMA_VERSION, MODEL_VERSION,
         sorted(dataclasses.asdict(hw).items())],
        sort_keys=True, default=str)
    return sha256(payload.encode()).hexdigest()[:16]


def host_fingerprint() -> str:
    """Hash of the execution substrate a record was produced on: the
    torch version, the device name and its CUDA capability (``cpu``
    where there is no card).  Stored with every record, deliberately
    NOT part of the entry path: a host change must not orphan the
    cache."""
    import platform

    import torch
    if torch.cuda.is_available():
        dev = [torch.cuda.get_device_name(0),
               list(torch.cuda.get_device_capability(0))]
    else:
        dev = ["cpu"]
    payload = json.dumps([torch.__version__, dev, platform.platform()])
    return sha256(payload.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Tiling-expression (de)serialization: Loop tree <-> nested lists
# ---------------------------------------------------------------------------

def expr_to_json(scope: Scope) -> list:
    return [[l.name, expr_to_json(l.body)] for l in scope]


def expr_from_json(data: list) -> Scope:
    return tuple(Loop(str(name), expr_from_json(body))
                 for name, body in data)


# ---------------------------------------------------------------------------
# Hardened read/write plumbing
# ---------------------------------------------------------------------------

def _quarantine_corrupt(path: Path) -> Optional[Path]:
    """Move a corrupt entry aside to ``<name>.corrupt`` (evidence
    preserved; the path frees up for the retuned replacement)."""
    dst = path.with_name(path.name + CORRUPT_SUFFIX)
    try:
        os.replace(path, dst)
        return dst
    except OSError:
        return None


def _read_record(path: Path, fault_kind: str) -> Optional[dict]:
    """Parse one record; None on miss.  Unparseable JSON — or a
    deterministically injected read fault (``fault_kind``) standing in
    for torn/bit-rotted storage — quarantines the file and misses."""
    from ..reliability import faults as _faults
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    try:
        if _faults.check(fault_kind, path=str(path)):
            raise ValueError(f"injected {fault_kind}")
        rec = json.loads(text)
        if not isinstance(rec, dict):
            raise ValueError("record is not a JSON object")
        return rec
    except ValueError:
        _quarantine_corrupt(path)
        return None


@contextlib.contextmanager
def _entry_lock(path: Path) -> Iterator[None]:
    """Advisory per-entry writer lock (``<name>.lock`` + flock).

    Serializes racing writers of the same key so tempfile churn stays
    bounded; correctness never depends on it — ``os.replace`` already
    keeps readers atomic — so it is best-effort and a no-op where
    flock is unavailable.
    """
    if fcntl is None:
        yield
        return
    lock_path = path.with_name(path.name + ".lock")
    try:
        f = open(lock_path, "a+")
    except OSError:
        yield
        return
    try:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
    finally:
        f.close()


def _atomic_write(path: Path, rec: dict) -> Optional[Path]:
    """Atomic temp-file + rename write under the advisory entry lock;
    best-effort (a read-only filesystem must not break tuning)."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with _entry_lock(path):
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(rec, f)
                os.replace(tmp, path)  # atomic: concurrent readers
            finally:                   # never see a half-written entry
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return path
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Load / store
# ---------------------------------------------------------------------------

def entry_path(key: tuple, hw: "TpuSpec | GpuSpec", trial: str = "analytic") -> Path:
    if trial not in TRIAL_KINDS:
        raise ValueError(f"unknown trial kind {trial!r}; "
                         f"expected one of {TRIAL_KINDS}")
    blob = json.dumps([list(key), model_fingerprint(hw), trial],
                      sort_keys=True, default=str)
    return cache_dir() / (sha256(blob.encode()).hexdigest()[:32] + ".json")


def load(key: tuple, hw: "TpuSpec | GpuSpec",
         trial: str = "analytic") -> Optional[dict]:
    """The persisted record for ``(key, trial)``, or None on
    miss/corruption — an entry of the other trial kind is a miss.

    Returns a dict with ``expr`` (Scope), ``tile_sizes``
    (dict[str, int]), ``best_time``, ``n_measured``, ``n_iterations``,
    ``n_candidates``, ``prune_stats``, ``history``, ``params``.
    """
    if not enabled():
        return None
    path = entry_path(key, hw, trial)
    rec = _read_record(path, "cache_corrupt")
    if rec is None:
        return None
    if rec.get("schema") != SCHEMA_VERSION:
        return None  # stale layout, not corruption: leave it in place
    if rec.get("key") != _jsonable_key(key):
        return None  # hash collision paranoia
    if rec.get("trial") != trial:
        return None  # kind mismatch paranoia (path already splits)
    try:
        return {
            "expr": expr_from_json(rec["expr"]),
            "tile_sizes": {str(k): int(v)
                           for k, v in rec["tile_sizes"].items()},
            "best_time": float(rec["best_time"]),
            "n_measured": int(rec["n_measured"]),
            "n_iterations": int(rec["n_iterations"]),
            "n_candidates": int(rec["n_candidates"]),
            "prune_stats": dict(rec["prune_stats"]),
            "history": [(int(i), float(t)) for i, t in rec["history"]],
            "params": dict(rec["params"]),
            "host": rec.get("host"),
        }
    except (ValueError, KeyError, TypeError, AttributeError):
        # parsed as JSON but the payload is mangled: quarantine too
        _quarantine_corrupt(path)
        return None


def _jsonable_key(key: tuple) -> list:
    # json round-trip normalizes tuples to lists so stored-key equality
    # checks compare like with like
    return json.loads(json.dumps(list(key), default=str))


def store(key: tuple, hw: "TpuSpec | GpuSpec", *, expr: Scope,
          tile_sizes: dict[str, int], best_time: float, n_measured: int,
          n_iterations: int, n_candidates: int, prune_stats: dict,
          history: list, params: dict,
          trial: str = "analytic") -> Optional[Path]:
    """Persist one search outcome; best-effort (failures are silent —
    a read-only filesystem must not break tuning)."""
    if not enabled():
        return None
    rec = {
        "schema": SCHEMA_VERSION,
        "model_fingerprint": model_fingerprint(hw),
        "trial": trial,
        "key": _jsonable_key(key),
        "expr": expr_to_json(expr),
        "tile_sizes": {k: int(v) for k, v in tile_sizes.items()},
        "best_time": float(best_time),
        "n_measured": int(n_measured),
        "n_iterations": int(n_iterations),
        "n_candidates": int(n_candidates),
        "prune_stats": {k: int(v) for k, v in prune_stats.items()},
        "history": [[int(i), float(t)] for i, t in history],
        "params": params,
        "host": host_fingerprint(),
    }
    return _atomic_write(entry_path(key, hw, trial), rec)


def quarantine_entry(key: tuple, hw: "TpuSpec | GpuSpec",
                     trial: str = "analytic") -> Optional[Path]:
    """Move the cached entry for ``key`` aside to ``.corrupt``: a
    record that *parses* but fails schedule re-validation is kept as
    evidence and the path frees up for a retune."""
    return _quarantine_corrupt(entry_path(key, hw, trial))


# ---------------------------------------------------------------------------
# Planner records (core/planner.py)
# ---------------------------------------------------------------------------
#
# A plan record persists one planner decision (carved chains + stitched
# glue for one block) under the ("plan", PLANNER_VERSION, config, batch,
# seq, stitch, hw, mesh, phase, paged, kv_len) fingerprint, so a serving
# relaunch replays its decode plan without re-carving.  The payload is
# the planner's own JSON form (planner.plan_to_json); this module only
# frames it with the schema/key cross-checks every other record gets.
# Same invalidation story: SCHEMA_VERSION, MODEL_VERSION and the
# hardware constants are folded into the path hash, and the caller's
# key carries PLANNER_VERSION.

def plan_entry_path(key: tuple, hw: "TpuSpec | GpuSpec") -> Path:
    blob = json.dumps([list(key), model_fingerprint(hw), "plan"],
                      sort_keys=True, default=str)
    return cache_dir() / (sha256(blob.encode()).hexdigest()[:32] + ".json")


def load_plan(key: tuple, hw: "TpuSpec | GpuSpec") -> Optional[dict]:
    """The persisted planner decision for ``key``, or None on
    miss/corruption.  Returns the raw plan payload dict."""
    if not enabled():
        return None
    path = plan_entry_path(key, hw)
    rec = _read_record(path, "plan_load")
    if rec is None:
        return None
    if rec.get("schema") != SCHEMA_VERSION:
        return None  # stale layout, not corruption: leave it in place
    if rec.get("kind") != "plan":
        return None
    if rec.get("key") != _jsonable_key(key):
        return None  # hash collision paranoia
    try:
        return dict(rec["plan"])
    except (ValueError, KeyError, TypeError):
        _quarantine_corrupt(path)
        return None


def store_plan(key: tuple, hw: "TpuSpec | GpuSpec",
               plan: dict) -> Optional[Path]:
    """Persist one planner decision; best-effort like ``store``."""
    if not enabled():
        return None
    rec = {
        "schema": SCHEMA_VERSION,
        "model_fingerprint": model_fingerprint(hw),
        "kind": "plan",
        "key": _jsonable_key(key),
        "plan": plan,
    }
    return _atomic_write(plan_entry_path(key, hw), rec)


# ---------------------------------------------------------------------------
# Denylist records (circuit-breaker quarantine; reliability/breaker.py)
# ---------------------------------------------------------------------------
#
# A denylist record marks a *fingerprint* (schedule key or plan key) as
# quarantined after a dispatch failure or a sentinel mismatch.  It
# deliberately does NOT remove the cached entry: deletion would make
# every relaunch miss, re-tune, re-fail and re-tune again.  The record
# is consulted at dispatch level (kernels/ops.py, models/layers.py,
# models/lm.py, serving/engine.py), so loads stay warm and the degraded
# twin is chosen without a search.

def deny_path(key: tuple, hw: "TpuSpec | GpuSpec") -> Path:
    blob = json.dumps([list(key), model_fingerprint(hw), "deny"],
                      sort_keys=True, default=str)
    name = "deny-" + sha256(blob.encode()).hexdigest()[:32] + ".json"
    return cache_dir() / name


def quarantine(key: tuple, hw: "TpuSpec | GpuSpec",
               reason: str = "") -> Optional[Path]:
    """Persist a denylist record for ``key``; best-effort."""
    if not enabled():
        return None
    rec = {
        "schema": SCHEMA_VERSION,
        "model_fingerprint": model_fingerprint(hw),
        "kind": "deny",
        "key": _jsonable_key(key),
        "reason": str(reason),
    }
    return _atomic_write(deny_path(key, hw), rec)


def is_quarantined(key: tuple, hw: "TpuSpec | GpuSpec") -> Optional[dict]:
    """The denylist record for ``key``, or None when not quarantined.

    An unreadable denylist record still counts as quarantined (fail
    closed: the degraded path is always correct, retrying a known-bad
    kernel is not).
    """
    if not enabled():
        return None
    path = deny_path(key, hw)
    try:
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
        if rec.get("kind") != "deny":
            return None
        return rec
    except OSError:
        return None
    except ValueError:
        return {"kind": "deny", "reason": "unreadable denylist record"}


def clear_quarantine(key: tuple, hw: "TpuSpec | GpuSpec") -> bool:
    """Lift the quarantine for ``key`` (operator override)."""
    try:
        deny_path(key, hw).unlink()
        return True
    except OSError:
        return False


def list_quarantined() -> list[dict]:
    """All readable denylist records in the cache dir."""
    out = []
    d = cache_dir()
    if d.is_dir():
        for p in sorted(d.glob("deny-*.json")):
            if not _DENY_NAME.fullmatch(p.name):
                continue
            try:
                with open(p, encoding="utf-8") as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                pass
    return out


def _ours(name: str) -> bool:
    return bool(_ENTRY_NAME.fullmatch(name) or _DENY_NAME.fullmatch(name))


def clear() -> int:
    """Delete every cache entry; returns the number of entries and
    denylist records removed.

    Only files of this module's naming — ``<32-hex>.json`` entries and
    plan records, ``deny-*.json`` records, and their ``*.corrupt`` /
    ``*.lock`` companions (not counted) — are touched: the cache
    directory may be a shared scratch directory holding other tools'
    JSON files."""
    n = 0
    d = cache_dir()
    if not d.is_dir():
        return n
    for p in d.glob("*.json"):
        if _ours(p.name):
            try:
                p.unlink()
                n += 1
            except OSError:
                pass
    for pattern in ("*.json" + CORRUPT_SUFFIX, "*.json.lock"):
        for p in d.glob(pattern):
            if _ours(p.name.split(".json", 1)[0] + ".json"):
                try:
                    p.unlink()
                except OSError:
                    pass
    return n
