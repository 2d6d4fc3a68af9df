"""Deterministic sharded token pipeline — the port's copy of the JAX
package's ``repro.data.pipeline`` (numpy only, the same arithmetic, so
``batch_at(step)`` gives the JAX package's batches bit for bit).

Synthetic (seeded) or file-backed (memory-mapped uint16 token stream).
Determinism contract for fault tolerance: batch t is a pure function of
(seed, step t, host_shard) — after a restart the runner fast-forwards
to the checkpointed step and gets bit-identical batches, so training
resumes on the exact sample stream (``runtime.fault_tolerance`` relies
on this).  Batches are numpy; ``launch.train`` moves them to the
model's device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1          # data-parallel host shards
    shard_id: int = 0
    path: Optional[str] = None  # file-backed corpus (np.memmap) if set


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global batch must divide across data shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards
        self._corpus = None
        if cfg.path:
            self._corpus = np.memmap(cfg.path, dtype=np.uint16, mode="r")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, shard) — the determinism anchor."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard_id]))
        if self._corpus is not None:
            max_start = len(self._corpus) - cfg.seq_len - 1
            starts = rng.integers(0, max_start, size=self.local_batch)
            toks = np.stack([self._corpus[s:s + cfg.seq_len + 1]
                             for s in starts]).astype(np.int32)
        else:
            toks = rng.integers(0, cfg.vocab,
                                size=(self.local_batch, cfg.seq_len + 1),
                                dtype=np.int32)
        return {"tokens": toks[:, :-1],
                "labels": np.ascontiguousarray(toks[:, 1:])}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchingLoader:
    """Background-thread prefetch (depth-N) over a TokenPipeline,
    resumable from an arbitrary step."""

    def __init__(self, pipeline: TokenPipeline, start_step: int = 0,
                 depth: int = 2):
        self.pipeline = pipeline
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.pipeline.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> tuple[int, dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
