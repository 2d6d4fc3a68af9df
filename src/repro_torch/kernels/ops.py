"""Dispatch points from model code to the tuned kernels, single
device (mesh dispatch is not ported yet).

* ``gemm_chain`` and ``attention`` are the quickstart front door and the
  cache-free forward's attention (``models/layers.attention_block``
  under ``Runtime(kernel_ops=True)``): each runs the CUDA kernel with
  the schedule ``core.api.fuse_gemm_chain`` / ``fuse_attention`` tuned
  for its shape.
* ``mlp_chain`` is the planner executor's MLP dispatch
  (``models/layers.run_planned_layer`` under
  ``Runtime(kernel_ops=True, planner=True)``): a planner-carved MLP
  chain runs the ``gemm_chain.fused_mlp_chain`` schedule that
  ``core.api.fuse_mlp_chain`` tuned for its shape.

A CUDA tensor launches the kernel; a CPU tensor runs the kernel's plain
version.  Every call is guarded (``_guarded``): a quarantined
fingerprint, or a dispatch that fails with an injected fault or a
launch the card refused (``reliability.breaker.degradable``), is served
by the unfused torch oracle of ``kernels/ref.py`` — never by the
kernel's plain version, which stays for the tests — and any other
failure raises through the guard.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import api
from . import ref


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _guarded(fingerprint: tuple, kernel_fn, ref_fn, rows=None):
    """Tiered dispatch for a fused-kernel tail, and for the paged decode
    kernel (``models/layers._paged_attention_body``).

    The breaker-open check routes a quarantined fingerprint straight to
    the torch twin without retrying it; otherwise the fused path runs
    behind the ``kernel_dispatch`` fault point, and a failure the
    breaker may degrade from (``breaker.degradable``) records the
    fingerprint (persisting a denylist record next to the cached
    schedule) before serving the twin; any other failure raises.

    The tail is also a sentinel seam: ``wrong_answer`` faults perturb
    the fused output here, and when shadow verification is armed
    (``reliability/sentinels.py``) a sampled subset of dispatches is
    re-run on the twin and compared within per-dtype tolerance — a
    mismatch quarantines the fingerprint exactly like a crash, and the
    caller receives the twin's output.  ``rows`` (a thunk of a boolean
    mask over the output's first axis) limits the comparison to the
    rows the caller reads.
    """
    from ..reliability import breaker as _breaker
    from ..reliability import faults as _faults
    from ..reliability import sentinels as _sentinels
    if _breaker.is_open(fingerprint):
        return ref_fn()
    try:
        _faults.fault_point("kernel_dispatch", op=str(fingerprint[0]))
        out = _sentinels.corrupt_if_armed(kernel_fn(),
                                          op=str(fingerprint[0]))
        return _sentinels.shadow_kernel(fingerprint, out, ref_fn, rows)
    except Exception as e:  # noqa: BLE001 - degrade or re-raise below
        if not _breaker.degradable(e):
            raise
        _breaker.record_failure(fingerprint,
                                reason=f"{type(e).__name__}: {e}")
        return ref_fn()


def gemm_chain(a: torch.Tensor, b: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    """Fused E = (A B) D with the tuned schedule.  a: (B, M, K),
    b: (B, K, N), d: (B, N, H)."""
    bsz, m, k = a.shape
    n, h = b.shape[-1], d.shape[-1]
    dt = _dtype_name(a)

    def _kernel():
        tk = api.fuse_gemm_chain(m, n, k, h, batch=bsz, dtype=dt)
        return tk(a.contiguous(), b.contiguous(), d.contiguous())

    return _guarded(("gemm", m, n, k, h, bsz, dt), _kernel,
                    lambda: ref.gemm_chain_ref(a, b, d))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Fused GQA attention with the tuned (bq, bkv).  q: (B, Hq, M, D),
    k/v: (B, Hkv, N, D/Dv); queries at the tail of the kv sequence."""
    b, hq, m, d = q.shape
    n, dv = v.shape[-2], v.shape[-1]
    dt = _dtype_name(q)

    def _kernel():
        tk = api.fuse_attention(m, n, d, dv, heads=hq, batch=b, dtype=dt,
                                causal=causal, window=window, scale=scale)
        return tk(q.contiguous(), k.contiguous(), v.contiguous())

    return _guarded(
        ("attn", m, n, d, dv, hq, b, dt, causal, window), _kernel,
        lambda: ref.gqa_attention_ref(q, k, v, causal=causal,
                                      window=window, scale=scale))


def mlp_chain(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
              w_gate: Optional[torch.Tensor] = None,
              act: str = "silu") -> torch.Tensor:
    """Fused E = (act(X Wg) * (X Wu)) Wd with the tuned schedule
    (``w_gate=None`` computes act(X Wu) Wd).

    x: (M, K); w_up/w_gate: (K, N); w_down: (N, H).  The schedule is
    tuned at ``dtype=str(x.dtype)`` — the chain the caller actually
    runs, f32 when a stitched ln2 leaves x f32-wide — while the weights
    keep their own type (the kernel widens them in registers)."""
    m, _ = x.shape
    n, h = w_up.shape[-1], w_down.shape[-1]
    gated = w_gate is not None
    dt = _dtype_name(x)

    def _kernel():
        tk = api.fuse_mlp_chain(m, n, h, batch=1, dtype=dt, gated=gated,
                                act=act)
        out = tk(x.contiguous()[None], w_up[None], w_down[None],
                 wg=w_gate[None] if gated else None)
        return out[0]

    return _guarded(("mlp", m, n, h, dt, gated, act), _kernel,
                    lambda: ref.mlp_chain_ref(x, w_up, w_down, wg=w_gate,
                                              act=act))
