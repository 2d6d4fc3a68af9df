"""Roofline terms of one step — the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``, priced under a hardware
descriptor (``core.perf_model.H100`` by default: 989e12 bf16 FLOP/s,
3.35e12 B/s of HBM, 450e9 B/s a direction of NVLink):

    compute    = flops per rank / peak FLOP/s
    memory     = bytes per rank / HBM bytes/s
    collective = link traffic per rank / link bytes/s

The flops, bytes and collectives come from ``launch.op_cost`` (one
rank's op stream), where the JAX package parses the compiled HLO.
``model_flops`` is the JAX package's 6·N·D (train) or 2·N·D
(inference) over the active parameters; ``kernelized_attention_bytes``
and ``planner_chain_report`` ask the port's tuner and planner, under
``hw``, what the fused attention kernel would move and what the planner
would carve for a cell.
"""
from __future__ import annotations

import dataclasses

from ..core.perf_model import H100
from .op_cost import CollectiveStats, Cost


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_traffic: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_device: float = 0.0
    useful_ratio: float = 0.0


def roofline_terms(cost: Cost, coll: CollectiveStats,
                   model_flops_per_device: float = 0.0,
                   hw=H100) -> Roofline:
    """The three terms of ``cost`` and ``coll`` under ``hw`` and the
    largest of them."""
    compute_s = cost.flops / hw.peak_flops
    memory_s = cost.bytes / hw.hbm_bw
    coll_s = coll.traffic_bytes / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops_per_device / cost.flops if cost.flops else 0.0
    return Roofline(cost.flops, cost.bytes, coll.traffic_bytes, compute_s,
                    memory_s, coll_s, dominant, model_flops_per_device,
                    useful)


def model_flops(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS per device: 6·N_active·D train, 2·N_active·D inference."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        total = 6.0 * n_active * shape.batch * shape.seq
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.batch * shape.seq
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.batch
    return total / n_devices


def _attention_spec(cfg, shape, mesh, rules, hw, **kw):
    from .mesh import tuner_mesh_spec
    return tuner_mesh_spec(mesh, rules, kind="attention", batch=shape.batch,
                           feature_dim=cfg.n_kv_heads, ici_bw=hw.ici_bw,
                           **kw)


def kernelized_attention_bytes(cfg, shape, n_dev: int, mesh=None,
                               rules=None, regime_log: dict | None = None,
                               hw=H100) -> tuple[float, int]:
    """Per-device bytes of all attention layers when each runs as the
    tuned fused attention kernel (score tiles on chip): ``t_mem`` of the
    schedule the port's tuner picks under ``hw`` for each (q_len,
    kv_len), times the layers, times 4 passes for a train cell (forward,
    recompute, backward ~2x), as the JAX package's.

    With a ``mesh`` (and the cell's ``Rules``) each layer shape runs the
    regime search ``kernels.ops`` dispatches — spatial (heads and batch
    over the data and tp dims) against ring (the kv sequence over tp) —
    and the bytes are one shard's under the winner; without one, the
    single-device kernel's bytes times ``batch * heads / n_dev``.
    ``regime_log`` records ``{"MxN": regime}``.  Returns (bytes, number
    of attention layers); a decode cell has none."""
    from ..core import api
    from ..core.perf_model import t_mem

    if shape.kind == "decode":
        return 0.0, 0
    dh, s = cfg.dh, shape.seq
    passes = 4.0 if shape.kind == "train" else 1.0
    spec = None
    if mesh is not None:
        spec = _attention_spec(cfg, shape, mesh, rules, hw)
        if spec.is_single:
            spec = None

    def layer_bytes(m, n):
        ring = None
        if mesh is not None:
            ring = _attention_spec(cfg, shape, mesh, rules, hw,
                                   reduction_dim=n, shard_reduction=True)
            if not any(l == "n" for l, _ in ring.placement):
                ring = None     # no dim divides kv: not a ring regime
        if spec is None and ring is None:
            tk = api.fuse_attention(m, n, dh, dh, heads=1, batch=1,
                                    dtype=cfg.dtype, hw=hw)
            hb = shape.batch * cfg.n_heads / n_dev
            return t_mem(tk.report.best, hw) * hw.hbm_bw * hb
        regimes = {"spatial": spec}
        if ring is not None:
            regimes["ring"] = ring
        choice = api.fuse_attention_regimes(
            m, n, dh, dh, heads=cfg.n_heads, batch=shape.batch,
            dtype=cfg.dtype, hw=hw, regimes=regimes)
        if regime_log is not None:
            regime_log[f"{m}x{n}"] = choice.regime
        b = t_mem(choice.kernel.report.best, hw) * hw.hbm_bw
        # the replicated spatial regime was tuned over the whole
        # head-batch, which the ranks still split
        return b / n_dev if choice.regime == "spatial" and spec is None \
            else b

    if cfg.family == "encdec":
        t = cfg.encoder.n_frames
        t_pad = 128 * ((t + 127) // 128)
        total = (layer_bytes(t_pad, t_pad) * cfg.encoder.n_layers
                 + layer_bytes(s, s) * cfg.n_layers
                 + layer_bytes(s, t_pad) * cfg.n_layers)
        count = cfg.encoder.n_layers + 2 * cfg.n_layers
    else:
        pat = list(cfg.pattern)
        count = sum(1 for i in range(cfg.n_layers)
                    if pat[i % len(pat)] == "attn")
        if count == 0:
            return 0.0, 0
        win = cfg.window or (cfg.rglru.local_window if cfg.rglru else 0)
        total = layer_bytes(s, min(s, win) if win else s) * count
    return total * passes, count


def planner_chain_report(cfg, shape, mesh=None, rules=None,
                         hw=H100) -> dict:
    """What the fusion planner would carve for one cell under ``hw`` and
    the cell's tuner ``MeshSpec``: the chains kept fused or split, the
    glue stitched or left standalone.  A decode cell plans the
    ``phase="decode"`` DAG against a ``shape.seq``-long cache, the
    others the cache-free forward; an arch the planner cannot plan
    reports ``{"plannable": False}``."""
    from ..core import planner

    if not planner.plannable(cfg):
        return {"plannable": False}
    spec = None
    if mesh is not None:
        spec = _attention_spec(cfg, shape, mesh, rules, hw)
        if spec.is_single:
            spec = None
    if shape.kind == "decode":
        plan = planner.plan_model(cfg, shape.batch, 1, mesh=spec, hw=hw,
                                  phase="decode", kv_len=shape.seq)
    else:
        plan = planner.plan_model(cfg, shape.batch, shape.seq, mesh=spec,
                                  hw=hw)
    chains = [{
        "kind": c.kind, "ops": list(c.ops), "fused": c.fused,
        "ai": round(c.ai, 1),
        "prologue": list(c.prologue), "epilogue": list(c.epilogue),
    } for c in plan.layer.chains]
    return {
        "plannable": True,
        "phase": plan.phase,
        "ridge": round(planner.ridge_intensity(hw), 1),
        "chains": chains,
        "n_fused": sum(1 for c in plan.layer.chains if c.fused),
        "n_split": sum(1 for c in plan.layer.chains if not c.fused),
        "n_stitched": len(plan.layer.stitched()),
        "glue_standalone": list(plan.layer.glue),
        "stitches_dropped": list(plan.layer.dropped),
    }
