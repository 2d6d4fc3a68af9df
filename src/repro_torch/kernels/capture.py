"""A step captured in a CUDA graph, with its kernels' launches counted.

Each kernel wrapper counts its own launches (``fused_attention.launches``
and so on) where it launches.  A replay of a CUDA graph runs the
launches its capture recorded without running any Python, so
``CapturedStep`` takes what the capture counted back out of the
counters and adds it again on every replay.  The eager warm-up that
precedes the capture is a real execution: its launches are kept apart
in ``warmup_launches`` and taken out of the counters too, so that the
counters read what the caller's own steps launched.

The counterpart of ``jax.jit`` around a step of the JAX package: the
caller keeps every input of the step in a tensor of fixed address and
shape on the card, writes new values into those tensors, and replays.
"""
from __future__ import annotations

from typing import Callable

import torch


def counters() -> dict:
    """Every kernel wrapper of the port, by name: the owners of the
    ``launches`` counters."""
    from . import attention as A
    from . import gemm_chain as G
    from . import gemm_chain3 as G3
    return {"fused_attention": A.fused_attention,
            "fused_attention_partial": A.fused_attention_partial,
            "fused_mlp_chain": G.fused_mlp_chain,
            "fused_gemm_chain": G.fused_gemm_chain,
            "fused_gemm_chain3": G3.fused_gemm_chain3}


def snapshot() -> dict[str, int]:
    return {name: fn.launches for name, fn in counters().items()}


def since(before: dict[str, int]) -> dict[str, int]:
    """The launches counted after ``before`` (a ``snapshot``), for the
    kernels that launched."""
    now = snapshot()
    return {name: now[name] - before[name] for name in now
            if now[name] != before[name]}


def restore(before: dict[str, int]) -> None:
    for name, fn in counters().items():
        fn.launches = before[name]


def add(counts: dict[str, int]) -> None:
    fns = counters()
    for name, n in counts.items():
        fns[name].launches += n


class CapturedStep:
    """``fn`` run once eagerly, then captured in a CUDA graph.

    ``fn()`` must read and write only tensors of fixed address (the
    caller's static inputs, the model's weights and caches) and return
    the tensors the caller reads after a replay.  The warm-up runs on
    the capture's stream under ``torch.cuda.set_sync_debug_mode
    ("error")``, so a hidden host sync raises there, before capture; it
    also builds the CUDA libraries and fills the tuner's and planner's
    memos, so the capture records launches only.  Its result is
    ``warmup_out``.  A failure of the warm-up, of the capture or of a
    replay raises: nothing here falls back to the eager step.  The
    serving engine's tiers (``serving/engine.py``) decide what runs
    after such a failure; the reliability guards inside ``fn`` run in
    the warm-up and the capture, never in a replay, and skip their
    shadow comparisons in both (a host sync).
    """

    def __init__(self, fn: Callable, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{device}")
        stream = torch.cuda.Stream(device)
        before = snapshot()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.warmup_out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.warmup_launches = since(before)
        captured = snapshot()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn()
        self.launches = since(captured)
        restore(before)

    def replay(self):
        """Run the captured step once; returns ``out``, overwritten in
        place by every replay."""
        self.graph.replay()
        add(self.launches)
        return self.out
