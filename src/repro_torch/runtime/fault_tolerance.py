"""Fault-tolerant step runner + straggler detection — the port of the
JAX package's ``repro.runtime.fault_tolerance``.

* ``StepRunner`` — drives training with periodic atomic checkpoints; on
  a step failure it restores the last committed checkpoint and replays
  the deterministic data stream (``data.pipeline`` contract), bounded
  by a retry budget.
  On a world (``mesh`` and the state's ``layouts``) the checkpoints
  are written gathered whole by one rank and restored re-sharded
  (``ckpt.checkpoint``); every rank runs the runner, steps alike and
  fails alike.
* ``StragglerMonitor`` — per-host step-time EWMA; hosts slower than
  ``threshold`` x median are flagged.
* ``elastic_remesh`` / ``replace_state`` — the shape of a smaller world
  from the surviving ranks, and a whole host-side state re-sharded onto
  it.  Checkpoints hold whole arrays, so re-placement onto any new mesh
  is a cut of each leaf by its layout: elasticity is a restart with
  another world size, the standard large-fleet design.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import tree as T
from ..ckpt import checkpoint as ckpt


class StepFailure(Exception):
    """Raised by a step function to signal a (simulated or real) fault."""


@dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.2          # EWMA coefficient
    threshold: float = 1.5      # x median = straggler
    ewma: Optional[np.ndarray] = None

    def record(self, host_times: np.ndarray) -> list[int]:
        if self.ewma is None:
            self.ewma = host_times.astype(np.float64).copy()
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * host_times
        med = float(np.median(self.ewma))
        return [i for i, t in enumerate(self.ewma)
                if t > self.threshold * med]


@dataclass
class StepRunner:
    """Run (step_fn, state, data) with checkpoint/restart semantics.
    ``state`` is a tree of tensors (``ckpt.restore`` returns new ones on
    each leaf's device, so ``step_fn`` takes the state it is given).  On
    a world: ``mesh`` and ``layouts``, the state's layouts (a tree
    mirroring it), with which every checkpoint is saved gathered whole
    by rank 0 and restored re-sharded."""

    step_fn: Callable[[Any, dict], Any]     # state, batch -> state, metrics
    batch_at: Callable[[int], dict]         # deterministic data access
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    keep: int = 2
    async_save: bool = False
    on_step: Optional[Callable[[int, dict], None]] = None
    mesh: Optional[Any] = None
    layouts: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None and self.async_save:
            raise ValueError("a sharded state's checkpoints are written "
                             "blocking (ckpt.save on a mesh)")

    def _restore(self, step: int, like):
        return ckpt.restore(self.ckpt_dir, step, like, self.layouts,
                            self.mesh)

    def _save(self, step: int, state):
        if self.mesh is not None:
            import torch.distributed as dist
            ckpt.save(self.ckpt_dir, step, state, layouts=self.layouts,
                      mesh=self.mesh)
            if dist.get_rank() == 0:
                ckpt.prune_old(self.ckpt_dir, self.keep)
            return None
        pending = ckpt.save(self.ckpt_dir, step, state,
                            blocking=not self.async_save)
        ckpt.prune_old(self.ckpt_dir, self.keep)
        return pending

    def resume_or_init(self, init_state) -> tuple[Any, int]:
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return init_state, 0
        return self._restore(last, init_state), last

    def run(self, init_state, n_steps: int) -> tuple[Any, list[dict]]:
        state, start = self.resume_or_init(init_state)
        metrics_log: list[dict] = []
        step = start
        retries = 0
        pending: Optional[Any] = None
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                batch = self.batch_at(step)
                state, metrics = self.step_fn(state, batch)
                metrics = dict(metrics)
                metrics["step_time"] = time.perf_counter() - t0
                metrics["step"] = step
                metrics_log.append(metrics)
                if self.on_step:
                    self.on_step(step, metrics)
                step += 1
                retries = 0
                if step % self.ckpt_every == 0 or step == n_steps:
                    pending = self._save(step, state)
            except StepFailure:
                retries += 1
                if retries > self.max_retries:
                    raise
                last = ckpt.latest_step(self.ckpt_dir)
                if last is not None:
                    state = self._restore(last, state)
                    step = last
                # else: replay from the current in-memory state
        if pending is not None:
            pending.join()
        return state, metrics_log


def elastic_remesh(surviving: Sequence[int], model_axis_size: int
                   ) -> tuple[tuple[int, int], list[int]]:
    """A smaller world from the surviving ranks: the model dim is kept
    whole (a replica's shards must stay complete) and the data dim
    shrinks to the largest power of two, so that the batch and FSDP
    dims keep dividing evenly and a checkpoint re-places without
    padding.  Returns the new ("data", "model") shape and the ranks kept
    (the first ones of ``surviving``), which become the new world's
    ranks in that order."""
    data = len(surviving) // model_axis_size
    if data == 0:
        raise ValueError("not enough survivors for one model replica")
    pow2 = 1
    while pow2 * 2 <= data:
        pow2 *= 2
    return (pow2, model_axis_size), list(surviving[:pow2 * model_axis_size])


def replace_state(state, mesh, specs, device=None) -> Any:
    """Re-shard a host-side whole state (a tree of tensors or arrays)
    onto this rank's place in ``mesh``: each leaf cut to its block by
    its layout in ``specs`` (a tree mirroring ``state``), on ``device``
    (default: where the leaf is)."""
    from ..dist.collectives import shard_dims

    def place(a, layout):
        t = shard_dims(torch.as_tensor(np.asarray(a)) if not isinstance(
            a, torch.Tensor) else a, layout, mesh)
        return t if device is None else t.to(device)
    return T.map_tree(place, state, specs)
