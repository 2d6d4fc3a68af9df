"""Dispatch points from model code to the tuned kernels, on one card or
over a mesh.

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

Mesh dispatch (``mesh=``, with ``dist.sharding.Rules``): each rank runs
the fused schedule on its block — the batch over the rules' data dims,
the output features (``gemm_chain``) or the heads (``attention``) over
tp-or-model — tuned for that local block under the matching
``MeshSpec``, so the tiles are the per-rank sub-problem's.  Dims the
mesh cannot divide stay whole.  ``attention`` searches the regimes
(``attention_regime_choice``: spatial, ring, ring-pipelined) and runs
the winner; the ring regimes run ``dist.ring_dispatch.ring_attention``.
With a mesh the tuning is analytic only (no numeric probe), as in the
JAX package, and every rank checks that the world reached one choice
before any collective runs (``_agree``).  Under a mesh the tensors in
and out are whole on every rank (the JAX package's global arrays);
``attention_shard`` is the per-rank body the model calls on its own
shards.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import torch

from ..core import api
from ..core.perf_model import H100, GpuSpec
from ..dist import ring_dispatch
from ..dist.collectives import axis
from ..dist.sharding import Rules, default_rules, dispatch_mesh_spec
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


_AGREED: set = set()


def _agree(key: tuple) -> None:
    """Every rank of the world must have reached the same regime and
    tiles for ``key``'s shape, or the collectives that follow would
    pair up wrongly and hang: an all-reduce MAX and MIN of a hash of
    the choice, once per choice and process."""
    import torch.distributed as dist
    if key in _AGREED or not dist.is_initialized():
        return
    h = zlib.crc32(repr(key).encode())
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([h, -h], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != h or int(t[1]) != -h:
        raise RuntimeError(f"the ranks chose differently for {key[:2]}")
    _AGREED.add(key)


def gemm_chain(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
               mesh=None, rules: Optional[Rules] = None) -> torch.Tensor:
    """Fused E = (A B) D with the tuned schedule.  a: (B, M, K),
    b: (B, K, N), d: (B, N, H).

    mesh: each rank runs the kernel on its block — the batch over the
    rules' data dims, H over tp-or-model — with the schedule tuned for
    that block (``rules`` defaults to the canonical data/model
    placement); the result is gathered whole on every rank."""
    bsz, m, k = a.shape
    n, h = b.shape[-1], d.shape[-1]
    dt = _dtype_name(a)
    if mesh is not None:
        rules = rules if rules is not None else default_rules(mesh)
        spec, baxes, hax = dispatch_mesh_spec(
            rules, mesh, kind="gemm", batch=bsz, feature_dims=(h,),
            ici_bw=H100.ici_bw)
        if baxes or hax:
            bx, hx = axis(mesh, baxes), axis(mesh, hax)
            if bx is not None:
                a, b, d = (bx.shard(t, 0) for t in (a, b, d))
            if hx is not None:
                d = hx.shard(d, 2)
            tk = api.fuse_gemm_chain(m, n, k, h, batch=bsz, dtype=dt,
                                     mesh=spec)
            _agree(("gemm", m, n, k, h, bsz, dt, spec.canonical(),
                    tuple(sorted(tk.params.as_kwargs().items()))))
            e = _guarded(
                ("gemm", m, n, k, h, bsz, dt, spec.canonical()),
                lambda: tk(a.contiguous(), b.contiguous(), d.contiguous()),
                lambda: ref.gemm_chain_ref(a, b, d))
            if hx is not None:
                e = hx.all_gather(e, 2)
            return bx.all_gather(e, 0) if bx is not None else e
        # nothing shardable on this mesh: one card's dispatch

    def _kernel():
        tk = api.fuse_gemm_chain(m, n, k, h, batch=bsz, dtype=dt)
        return tk(a.contiguous(), b.contiguous(), d.contiguous())

    return _guarded(("gemm", m, n, k, h, bsz, dt), _kernel,
                    lambda: ref.gemm_chain_ref(a, b, d))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, window: int = 0,
              scale: Optional[float] = None, mesh=None,
              rules: Optional[Rules] = None) -> torch.Tensor:
    """Fused GQA attention with the tuned (bq, bkv).  q: (B, Hq, M, D),
    k/v: (B, Hkv, N, D/Dv); queries at the tail of the kv sequence.

    mesh: ``attention_shard`` (the tuner's regime) on each rank's
    block of the whole tensors; the output is gathered whole on every
    rank."""
    if mesh is not None:
        rules = rules if rules is not None else default_rules(mesh)
        b, hq, hkv = q.shape[0], q.shape[1], k.shape[1]
        _, baxes, hax = dispatch_mesh_spec(
            rules, mesh, kind="attention", batch=b,
            feature_dims=(hkv, hq), ici_bw=H100.ici_bw)
        bx, hx = axis(mesh, baxes), axis(mesh, hax)
        if bx is not None:
            q, k, v = (bx.shard(t, 0) for t in (q, k, v))
        if hx is not None:
            q, k, v = (hx.shard(t, 1) for t in (q, k, v))
        o = attention_shard(q, k, v, batch=b, q_heads=hq, kv_heads=hkv,
                            mesh=mesh, rules=rules, causal=causal,
                            window=window, scale=scale)
        if hx is not None:
            o = hx.all_gather(o, 1)
        return bx.all_gather(o, 0) if bx is not None else o
    return _attn_body(q, k, v, spec=None, batch=q.shape[0],
                      heads=q.shape[1], causal=causal, window=window,
                      scale=scale)


def attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    batch: int, q_heads: int, kv_heads: int, mesh,
                    rules: Rules, causal: bool = False, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """One rank's part of mesh attention over the global batch
    ``batch`` and ``q_heads``/``kv_heads`` heads.  q/k/v hold this
    rank's batch rows (``batch_placement``) and, where the spatial
    placement has a feature dim (``dispatch_mesh_spec``), this rank's
    q and kv heads; every head otherwise.  Returns the output in q's
    layout.

    Regimes (``attention_regime_choice``):
    * spatial — ``_attn_body``, the normalised kernel on the local
      block, its tiles tuned under the spatial MeshSpec; no collective;
    * ring / ring-pipelined — the heads gathered whole, the kv sequence
      split over tp-or-model, ``ring_dispatch.ring_attention``, and this
      rank's heads taken back out."""
    m, d = q.shape[2], q.shape[3]
    n, dv = v.shape[-2], v.shape[-1]
    spatial = dispatch_mesh_spec(
        rules, mesh, kind="attention", batch=batch,
        feature_dims=(kv_heads, q_heads), ici_bw=H100.ici_bw)
    choice, plan = attention_regime_choice(
        rules, mesh, batch=batch, q_heads=q_heads, kv_heads=kv_heads,
        q_len=m, kv_len=n, head_dim=d, v_dim=dv, dtype=_dtype_name(q),
        causal=causal, window=window, scale=scale, spatial=spatial)
    spec = spatial[0] if (spatial[1] or spatial[2]) else None
    if choice is None or choice.regime == "spatial":
        return _attn_body(q, k, v, spec=spec, batch=batch, heads=q_heads,
                          causal=causal, window=window, scale=scale,
                          tk=choice.kernel if choice is not None else None)
    p = choice.kernel.params
    _agree(("attn", choice.regime, tuple(q.shape), tuple(k.shape), causal,
            window, p.bq, p.bkv))
    hx = axis(mesh, spatial[2])
    if hx is not None:
        q, k, v = (hx.all_gather(t, 1) for t in (q, k, v))
    o = ring_dispatch.ring_attention(
        q, k, v, mesh=mesh, axis_name=plan.axis, causal=causal,
        window=window, scale=scale, bq=p.bq, bkv=p.bkv,
        pipelined=choice.regime == "ring-pipelined")
    return hx.shard(o, 1).contiguous() if hx is not None else o


def _attn_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, spec,
               batch: int, heads: int, causal: bool, window: int,
               scale: Optional[float], tk=None) -> torch.Tensor:
    """The spatial regime on one rank's block (one card's whole tensors
    when ``spec`` is None): the normalised kernel under its guard, with
    the tiles ``tk`` carries or those tuned for the global ``batch`` x
    ``heads`` shape under ``spec``."""
    bl, hl, m, d = q.shape
    n, dv = v.shape[-2], v.shape[-1]
    dt = _dtype_name(q)

    def _tuned():       # one card's tuning probes the kernel: guarded
        return tk if tk is not None else api.fuse_attention(
            m, n, d, dv, heads=heads, batch=batch, dtype=dt, causal=causal,
            window=window, scale=scale, mesh=spec)

    fp = ("attn", m, n, d, dv, hl, bl, dt, causal, window)
    if spec is not None:
        tk = _tuned()
        _agree(("attn", "spatial", tuple(q.shape), tuple(k.shape), causal,
                window, tk.params.bq, tk.params.bkv))
        fp += (spec.canonical(),)
    return _guarded(
        fp, lambda: _tuned()(q.contiguous(), k.contiguous(), v.contiguous()),
        lambda: ref.gqa_attention_ref(q, k, v, causal=causal,
                                      window=window, scale=scale))


def _pipelined_rows_ok(plan, batch: int, q_heads: int, q_len: int) -> bool:
    """Whether the pipelined ring combine can run for this shape: its
    reduce-scatter chunks the per-rank output rows ``(batch /
    batch_factor) * q_heads * q_len`` evenly across the ring."""
    n = plan.n_shards
    bf = plan.spec.batch_factor()
    if n < 2 or batch % bf:
        return False
    return (batch // bf) * q_heads * q_len % n == 0


def attention_regime_choice(rules: Rules, mesh, *, batch: int,
                            q_heads: int, kv_heads: int, q_len: int,
                            kv_len: int, head_dim: int,
                            v_dim: Optional[int] = None,
                            dtype: str = "float32", causal: bool = False,
                            window: int = 0, scale: Optional[float] = None,
                            hw=H100, spatial=None):
    """(RegimeChoice, RingPlan) for one attention shape on this mesh —
    the decision ``attention`` dispatches, without running anything.
    ``(None, None)`` when the mesh offers no kv split (the spatial
    regime is then the only one).  The spatial entry is the
    ``dispatch_mesh_spec`` placement when one exists, else None
    (replicated), listed first so ties break to it; ``spatial`` passes
    a placement the caller already derived.  The collective terms are
    priced at ``hw.ici_bw``; the ring regimes are tuned as the partial
    kernel each rank runs.  Under a ``GpuSpec`` they are offered at one
    query row only: at more rows each rank runs the partial kernel with
    the kv heads repeated (``ring_dispatch.ring_group``), a block the
    H100 ran 30x slower than the spatial block and 16x over its price
    (qwen3-8b's forward at 1 x 4), so the spatial regime is the one
    there (the plan is still returned, for a caller that forces the
    ring)."""
    v_dim = head_dim if v_dim is None else v_dim
    if spatial is None:
        spatial = dispatch_mesh_spec(
            rules, mesh, kind="attention", batch=batch,
            feature_dims=(kv_heads, q_heads), ici_bw=hw.ici_bw)
    spec, baxes, hax = spatial
    plan = ring_dispatch.plan_ring_attention(
        rules, mesh, batch=batch, kv_len=kv_len,
        feature_dims=(kv_heads, q_heads), ici_bw=hw.ici_bw)
    if plan is None:
        return None, None
    regimes = {"spatial": spec if (baxes or hax) else None}
    if q_len == 1 or not isinstance(hw, GpuSpec):
        regimes["ring"] = plan.spec
        if _pipelined_rows_ok(plan, batch, q_heads, q_len):
            regimes["ring-pipelined"] = dataclasses.replace(
                plan.spec, pipelined=True)
    choice = api.fuse_attention_regimes(
        q_len, kv_len, head_dim, v_dim, heads=q_heads, batch=batch,
        dtype=dtype, causal=causal, window=window, scale=scale, hw=hw,
        regimes=regimes, kv_heads=kv_heads)
    return choice, plan


def paged_attention_regime_choice(rules: Rules, mesh, *, batch: int,
                                  q_heads: int, kv_heads: int, q_len: int,
                                  kv_len: int, head_dim: int,
                                  page_size: int,
                                  v_dim: Optional[int] = None,
                                  dtype: str = "float32", window: int = 0,
                                  scale: Optional[float] = None, hw=H100):
    """(RegimeChoice, RingPlan | None) for one PAGED decode shape — the
    serving twin of ``attention_regime_choice``; never ``(None,
    None)``: a mesh with no kv split still has paged-spatial.
    Candidates: paged-spatial (batch and heads over the mesh per
    ``dispatch_mesh_spec``, or replicated); paged-ring (page-table
    columns over tp-or-model, offered only when the dim divides the
    page count); paged-ring-pipelined (when the decode rows also chunk
    evenly over the ring).  Each is tuned through
    ``api.fuse_attention_paged``."""
    v_dim = head_dim if v_dim is None else v_dim
    spec, baxes, hax = dispatch_mesh_spec(
        rules, mesh, kind="attention", batch=batch,
        feature_dims=(kv_heads, q_heads), ici_bw=hw.ici_bw)
    plan = ring_dispatch.plan_ring_attention(
        rules, mesh, batch=batch, kv_len=kv_len,
        feature_dims=(kv_heads, q_heads), ici_bw=hw.ici_bw)
    if plan is not None and (kv_len % page_size
                             or (kv_len // page_size) % plan.n_shards):
        plan = None
    regimes = {"paged-spatial": spec if (baxes or hax) else None}
    if plan is not None:
        regimes["paged-ring"] = plan.spec
        if _pipelined_rows_ok(plan, batch, q_heads, q_len):
            regimes["paged-ring-pipelined"] = dataclasses.replace(
                plan.spec, pipelined=True)
    choice = api.fuse_attention_paged_regimes(
        q_len, kv_len, head_dim, v_dim, page_size=page_size,
        kv_heads=kv_heads, heads=q_heads, batch=batch, dtype=dtype,
        window=window, scale=scale, hw=hw, regimes=regimes)
    return choice, plan


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
