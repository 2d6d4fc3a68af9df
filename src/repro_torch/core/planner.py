"""Graph-level fusion planner: MBCI chains are *discovered*, not
hand-enumerated (the paper's premise).

``models/layers.py`` hand-wires which ops form each fused chain; this
module derives the same decisions from a model config alone, for the
hardware descriptor it is given (``H100`` by default; ``V5E`` reproduces
the JAX package's TPU plans decision for decision):

1. **Trace** — ``layer_op_dag`` expands one transformer block of an
   attention-only config into a small op DAG: compute-intensive nodes
   (projections, the attention core, the MLP GEMMs) and memory-bound
   glue (norms, rope, residual adds, SwiGLU gating, softmax).  Three
   block variants share the tracer: the cache-free training forward
   (``phase="forward"``) and the serving phases (``"prefill"`` /
   ``"decode"``), which insert the KV-cache write-through as an
   explicit ``kv_write`` glue node and open the attention kv extent to
   the cache length instead of the query length.
2. **Carve** — template groups of CI nodes connected through
   single-consumer glue become candidate chains (``chain.
   attention_chain``, ``chain.mlp_chain``); a candidate stays fused
   only if the MBCI predicate holds — its *localized* arithmetic
   intensity (under the active ``MeshSpec``) is below the hardware
   ridge point ``peak_flops / hbm_bw`` (``perf_model``; 295 on an
   H100), i.e. the fused chain is memory-bound and fusion saves
   device-memory round trips.
   Compute-bound candidates split into ``single_gemm`` units, the
   paper's unfused baseline.
3. **Stitch** — remaining glue is attached to adjacent carved chains
   as prologue/epilogue expressions (FusionStitching, PAPERS.md):
   epilogue when the chain's output is consumed solely by the glue,
   prologue when the glue's output feeds exactly one chain.  Each
   stitch passes ``pruning.stitched_vmem_ok`` (the Rule-4 extension,
   shared memory under ``GpuSpec``) or is dropped and recorded.  Stitching is deterministic: glue is
   visited in topological order, epilogue attachment is tried first.

Plans persist in ``core.schedule_cache`` under a ``("plan", …)``
fingerprint next to the tuned schedules, so a serving relaunch replays
the decisions without re-planning; the ``Runtime(planner=True)`` path
(``models/lm.py``) then executes blocks from plan output with zero
hand-specified chains — bit-identical to the hand-wired layers when
stitching is disabled.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

from . import schedule_cache
from .chain import (Chain, DTYPE_BYTES, attention_chain, mlp_chain,
                    single_gemm)
from .perf_model import GpuSpec, H100, MeshSpec, TpuSpec, chain_peak_flops
from .pruning import stitched_vmem_ok

# Bump when the carve/stitch semantics change: old plan records become
# invisible (the version is a key component) instead of being replayed
# with new meaning.  v2: phase-keyed plans (forward/prefill/decode),
# paged page-size and kv-cache extent join the fingerprint, and the
# serving DAGs gain the ``kv_write`` glue node.
PLANNER_VERSION = 2

PHASES = ("forward", "prefill", "decode")


# ---------------------------------------------------------------------------
# Op DAG
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OpNode:
    """One op of a transformer block.

    kind "ci" = compute-intensive (matmul-class, carvable into chains);
    "glue" = memory-bound elementwise/reduction glue.  ``ins`` names
    producer nodes ("x" is the block input).  Roles drive both the
    planner's stitching rules and the executor's dispatch
    (``models/layers.py::run_planned_layer``).
    """

    name: str
    kind: str   # "ci" | "glue"
    role: str   # ci: "gemm" | "attn_qk" | "attn_pv"
    #            glue: "norm" | "qk_norm" | "rope" | "softmax"
    #                  | "residual" | "gate_act" | "kv_write"
    ins: tuple[str, ...]


def plannable(cfg) -> bool:
    """Configs the planner can trace: a homogeneous stack of dense
    attention blocks with an MLP.  MoE (capacity-dropped routing),
    SSM/RG-LRU recurrences and encoder-decoder wiring have op DAGs this
    tracer does not model; ``Runtime(planner=True)`` runs the
    hand-wired blocks for them."""
    return (all(k == "attn" for k in cfg.pattern)
            and cfg.moe is None and cfg.ssm is None
            and cfg.rglru is None and cfg.encoder is None
            and cfg.d_ff > 0)


def gated(cfg) -> bool:
    """Whether the config's MLP is gated (two up-projections)."""
    return cfg.act in ("swiglu", "geglu")


def act_name(cfg) -> str:
    """The MLP's activation (the gate's, when gated)."""
    return {"swiglu": "silu", "geglu": "gelu"}.get(cfg.act, "gelu")


def layer_op_dag(cfg, phase: str = "forward") -> tuple[OpNode, ...]:
    """One attention block of ``cfg`` as an op DAG, topologically
    ordered.  All blocks of a plannable config are identical, so one
    DAG plans the whole stack.

    ``phase`` selects the block variant.  ``"forward"`` is the
    cache-free dense forward.  ``"prefill"`` and
    ``"decode"`` are the serving variants: the freshly projected
    (and rope'd) k together with v is written through to the KV cache
    — an explicit ``kv_write`` glue node (contiguous slice update or
    paged ``scatter_pages``) — and the attention core reads the cache,
    so its kv extent is the cache length, not the query length
    (``kv_len`` at carve time).  Decode is prefill at query length 1;
    the DAGs differ only through the shapes the carver judges.
    """
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} not in {PHASES}")
    if not plannable(cfg):
        raise ValueError(f"config {cfg.name!r} is not plannable")
    serving = phase != "forward"
    nodes: list[OpNode] = []
    add = nodes.append
    add(OpNode("ln1", "glue", "norm", ("x",)))
    add(OpNode("wq", "ci", "gemm", ("ln1",)))
    add(OpNode("wk", "ci", "gemm", ("ln1",)))
    add(OpNode("wv", "ci", "gemm", ("ln1",)))
    q, k = "wq", "wk"
    if cfg.qk_norm:
        add(OpNode("qk_norm_q", "glue", "qk_norm", (q,)))
        add(OpNode("qk_norm_k", "glue", "qk_norm", (k,)))
        q, k = "qk_norm_q", "qk_norm_k"
    if cfg.use_rope:
        add(OpNode("rope_q", "glue", "rope", (q,)))
        add(OpNode("rope_k", "glue", "rope", (k,)))
        q, k = "rope_q", "rope_k"
    v = "wv"
    if serving:
        # HBM write-through of this step's k/v into the cache; the
        # attention core then reads k and v *from the cache*, so qk/pv
        # depend on the write, not on the projection tails directly.
        add(OpNode("kv_write", "glue", "kv_write", (k, v)))
        k = v = "kv_write"
    add(OpNode("qk", "ci", "attn_qk", (q, k)))
    add(OpNode("softmax", "glue", "softmax", ("qk",)))
    add(OpNode("pv", "ci", "attn_pv", ("softmax", v)))
    add(OpNode("wo", "ci", "gemm", ("pv",)))
    add(OpNode("res1", "glue", "residual", ("wo", "x")))
    add(OpNode("ln2", "glue", "norm", ("res1",)))
    if gated(cfg):
        add(OpNode("w_gate", "ci", "gemm", ("ln2",)))
        add(OpNode("w_up", "ci", "gemm", ("ln2",)))
        add(OpNode("act_gate", "glue", "gate_act", ("w_gate", "w_up")))
    else:
        add(OpNode("w_up", "ci", "gemm", ("ln2",)))
        add(OpNode("act_gate", "glue", "gate_act", ("w_up",)))
    add(OpNode("w_down", "ci", "gemm", ("act_gate",)))
    add(OpNode("res2", "glue", "residual", ("w_down", "res1")))
    return tuple(nodes)


# ---------------------------------------------------------------------------
# Plan IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CarvedChain:
    """One carved execution unit: a fused MBCI chain or an unfused
    ``single_gemm``.  ``ops`` are the DAG nodes the unit covers
    (including interior glue like the softmax of a fused attention
    chain); ``prologue``/``epilogue`` are glue nodes stitched around it
    by the FusionStitching pass.  ``ai`` is the localized arithmetic
    intensity the MBCI predicate judged."""

    kind: str                       # "attention" | "mlp" | "gemm"
    ops: tuple[str, ...]
    fused: bool
    ai: float
    prologue: tuple[str, ...] = ()
    epilogue: tuple[str, ...] = ()


@dataclass(frozen=True)
class LayerPlan:
    nodes: tuple[OpNode, ...]
    chains: tuple[CarvedChain, ...]
    glue: tuple[str, ...]      # standalone glue (not carved, not stitched)
    dropped: tuple[str, ...]   # stitches rejected by stitched_vmem_ok

    def stitched(self) -> tuple[str, ...]:
        out: list[str] = []
        for c in self.chains:
            out += list(c.prologue) + list(c.epilogue)
        return tuple(out)


@dataclass(frozen=True)
class Plan:
    version: int
    config: str
    batch: int
    seq: int
    dtype: str
    stitch: bool
    mesh: Optional[tuple]   # MeshSpec.canonical(), or None
    n_layers: int
    layer: LayerPlan        # all blocks of a plannable config are alike
    phase: str = "forward"  # "forward" | "prefill" | "decode"
    paged: Optional[int] = None    # page size of a paged-serving plan
    kv_len: Optional[int] = None   # attention kv extent (cache length)


# ---------------------------------------------------------------------------
# Carving
# ---------------------------------------------------------------------------

def ridge_intensity(hw: "TpuSpec | GpuSpec" = H100,
                    chain: Optional[Chain] = None) -> float:
    """The roofline ridge point: chains below it are memory-bound.
    With a ``chain``, the ridge at the peak rate of its operations
    (``perf_model.chain_peak_flops``): under ``GpuSpec`` an f32 chain
    meets its ridge at the CUDA cores' rate, ~20 flops a byte on an
    H100 against the tensor cores' ~295; under ``TpuSpec`` every chain
    has the one ridge."""
    peak = hw.peak_flops if chain is None else chain_peak_flops(chain, hw)
    return peak / hw.hbm_bw


def _local_ai(chain: Chain, mesh: Optional[MeshSpec]) -> float:
    local = mesh.localize(chain) if mesh is not None else chain
    return local.arithmetic_intensity()


def _template_chains(cfg, batch: int, seq: int,
                     kv_len: Optional[int] = None
                     ) -> list[tuple[str, tuple[str, ...], Chain]]:
    """The candidate units of one block, in topological order:
    (kind, covered DAG nodes, the Chain to judge/price).  ``kv_len``
    opens the attention kv extent past the query length (serving
    phases read the whole cache; ``None`` means kv == seq)."""
    d, dh = cfg.d_model, cfg.dh
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    kv = kv_len if kv_len is not None else seq
    out: list[tuple[str, tuple[str, ...], Chain]] = [
        ("gemm", ("wq",), single_gemm(seq, hq * dh, d, batch=batch,
                                      dtype=dt, name="wq")),
        ("gemm", ("wk",), single_gemm(seq, hkv * dh, d, batch=batch,
                                      dtype=dt, name="wk")),
        ("gemm", ("wv",), single_gemm(seq, hkv * dh, d, batch=batch,
                                      dtype=dt, name="wv")),
        ("attention", ("qk", "softmax", "pv"),
         attention_chain(seq, kv, dh, dh, heads=hq, batch=batch,
                         dtype=dt, causal=True, window=cfg.window)),
        ("gemm", ("wo",), single_gemm(seq, d, hq * dh, batch=batch,
                                      dtype=dt, name="wo")),
    ]
    mlp_ops = (("w_gate", "w_up", "act_gate", "w_down") if gated(cfg)
               else ("w_up", "act_gate", "w_down"))
    out.append(("mlp", mlp_ops,
                mlp_chain(seq, cfg.d_ff, d, batch=batch, dtype=dt,
                          gated=gated(cfg), act=act_name(cfg))))
    return out


def _split_chains(kind: str, cfg, batch: int, seq: int,
                  kv_len: Optional[int] = None
                  ) -> list[tuple[tuple[str, ...], Chain]]:
    """Unfused fallback for a compute-bound template: one
    ``single_gemm`` per CI op; interior glue goes standalone."""
    d, dh = cfg.d_model, cfg.dh
    hq = cfg.n_heads
    dt = cfg.dtype
    kv = kv_len if kv_len is not None else seq
    if kind == "attention":
        bb = batch * hq
        return [(("qk",), single_gemm(seq, kv, dh, batch=bb, dtype=dt,
                                      name="qk")),
                (("pv",), single_gemm(seq, dh, kv, batch=bb, dtype=dt,
                                      name="pv"))]
    ff = cfg.d_ff
    out = []
    if gated(cfg):
        out.append((("w_gate",), single_gemm(seq, ff, d, batch=batch,
                                             dtype=dt, name="w_gate")))
    out.append((("w_up",), single_gemm(seq, ff, d, batch=batch,
                                       dtype=dt, name="w_up")))
    out.append((("w_down",), single_gemm(seq, d, ff, batch=batch,
                                         dtype=dt, name="w_down")))
    return out


# ---------------------------------------------------------------------------
# Stitching
# ---------------------------------------------------------------------------

def _glue_extra_bytes(node: OpNode, cfg, seq: int, unit: int) -> int:
    """Extra on-chip operand bytes a stitched glue op adds to the host
    kernel's tiles (weights/tables/extra streams; the main operand is
    already the chain's own tile).  ``unit`` is the descriptor's tile
    granularity (``hw.tile_unit``)."""
    dtb = DTYPE_BYTES[cfg.dtype]
    if node.role == "norm":
        return cfg.d_model * 4 * (2 if cfg.norm == "layernorm" else 1)
    if node.role == "qk_norm":
        return cfg.dh * 4
    if node.role == "rope":
        return unit * cfg.dh * 4           # cos/sin tile, f32
    if node.role == "residual":
        return min(seq, unit) * min(cfg.d_model, unit) * dtb
    if node.role == "gate_act":
        return min(seq, unit) * min(cfg.d_ff, unit) * dtb
    return 0                # softmax / kv_write: no extra operands


def _stitch_full_loops(node: OpNode, as_epilogue: bool) -> tuple[str, ...]:
    """Loops of the host chain a stitch forces to full extent (the glue
    reduces over them, so tile-locality requires an untiled sweep):
    a norm prologue normalizes the chain's contraction axis ``k``; a
    softmax epilogue needs the full score row ``n``."""
    if node.role == "norm" and not as_epilogue:
        return ("k",)
    if node.role == "softmax" and as_epilogue:
        return ("n",)
    return ()


def _carve_and_stitch(cfg, batch: int, seq: int, *, stitch: bool,
                      hw: "TpuSpec | GpuSpec", mesh: Optional[MeshSpec],
                      phase: str = "forward",
                      kv_len: Optional[int] = None) -> LayerPlan:
    nodes = layer_op_dag(cfg, phase)
    present = {n.name for n in nodes}

    carved: list[dict] = []      # mutable while stitching
    chain_objs: list[Chain] = []
    covered: dict[str, int] = {}

    def add(kind: str, ops: tuple[str, ...], fused: bool, ch: Chain):
        ops = tuple(o for o in ops if o in present)
        idx = len(carved)
        carved.append({"kind": kind, "ops": ops, "fused": fused,
                       "ai": _local_ai(ch, mesh),
                       "prologue": [], "epilogue": [], "out": ops[-1]})
        chain_objs.append(ch)
        for o in ops:
            covered[o] = idx

    for kind, ops, ch in _template_chains(cfg, batch, seq, kv_len):
        if len(ops) == 1:
            add(kind, ops, False, ch)
        elif _local_ai(ch, mesh) < ridge_intensity(hw, ch):
            add(kind, ops, True, ch)     # MBCI: keep fused
        else:                            # compute-bound: split
            for sub_ops, sub_ch in _split_chains(kind, cfg, batch, seq,
                                                 kv_len):
                add("gemm", sub_ops, False, sub_ch)

    consumers: dict[str, tuple[str, ...]] = {
        n.name: tuple(m.name for m in nodes if n.name in m.ins)
        for n in nodes}

    # ``owner`` extends ``covered`` with stitched glue, so epilogues
    # chain (wq -> qk_norm_q -> rope_q all ride the wq unit).
    owner = dict(covered)
    chain_out = {i: c["out"] for i, c in enumerate(carved)}
    glue_standalone: list[str] = []
    dropped: list[str] = []

    for node in nodes:
        g = node.name
        if node.kind != "glue" or g in covered:
            continue
        if node.role == "kv_write":
            # The cache write-through is a device-memory scatter by
            # design — there is no on-chip tile to stitch it into (the attention
            # core reads the *whole cache*, not this step's slice), so
            # it always executes standalone, never as an epilogue of
            # the k/v projections.
            glue_standalone.append(g)
            continue
        if not stitch:
            glue_standalone.append(g)
            continue
        # epilogue first: the chain's output is consumed solely by g
        target = None
        as_epi = False
        for src in node.ins:
            if (src in owner and chain_out[owner[src]] == src
                    and consumers[src] == (g,)):
                target, as_epi = owner[src], True
                break
        if target is None:
            # prologue: g's output feeds ops of exactly one chain
            cons = consumers[g]
            cons_chains = {covered[c] for c in cons if c in covered}
            if cons and len(cons_chains) == 1 \
                    and all(c in covered for c in cons):
                target = next(iter(cons_chains))
        if target is None:
            glue_standalone.append(g)
            continue
        ok = stitched_vmem_ok(
            chain_objs[target],
            _glue_extra_bytes(node, cfg, seq, hw.tile_unit), hw,
            unit=hw.tile_unit, full_loops=_stitch_full_loops(node, as_epi))
        if not ok:
            dropped.append(g)
            glue_standalone.append(g)
            continue
        if as_epi:
            carved[target]["epilogue"].append(g)
            chain_out[target] = g
            owner[g] = target
        else:
            carved[target]["prologue"].append(g)
            owner[g] = target

    chains = tuple(CarvedChain(kind=c["kind"], ops=c["ops"],
                               fused=c["fused"], ai=c["ai"],
                               prologue=tuple(c["prologue"]),
                               epilogue=tuple(c["epilogue"]))
                   for c in carved)
    return LayerPlan(nodes=nodes, chains=chains,
                     glue=tuple(glue_standalone), dropped=tuple(dropped))


# ---------------------------------------------------------------------------
# Plan cache + entry points
# ---------------------------------------------------------------------------

_PLAN_MEMO: dict[tuple, Plan] = {}


def config_fingerprint(cfg) -> tuple:
    """The structural fields the op DAG and chain dims derive from."""
    return (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.dh, cfg.d_ff, cfg.act, cfg.norm,
            cfg.use_rope, cfg.qk_norm, cfg.window, cfg.dtype)


def plan_key(cfg, batch: int, seq: int, stitch: bool,
             hw: "TpuSpec | GpuSpec" = H100,
             mesh: Optional[MeshSpec] = None,
             phase: str = "forward", paged: Optional[int] = None,
             kv_len: Optional[int] = None) -> tuple:
    return ("plan", PLANNER_VERSION, config_fingerprint(cfg), batch, seq,
            bool(stitch), hw.name,
            mesh.canonical() if mesh is not None else None,
            phase, paged, kv_len)


def clear_memo() -> None:
    """Drop the per-process plan memo (tests)."""
    _PLAN_MEMO.clear()


def plan_model(cfg, batch: int, seq: int, *, stitch: bool = True,
               hw: "TpuSpec | GpuSpec" = H100,
               mesh: Optional[MeshSpec] = None,
               use_cache: bool = True, phase: str = "forward",
               paged: Optional[int] = None,
               kv_len: Optional[int] = None) -> Plan:
    """Plan one model: carve + stitch a block, replaying from the
    ``("plan", …)`` record in ``core.schedule_cache`` when one exists
    (a serving relaunch never re-plans).  Memoized in-process, so the
    ``Runtime(planner=True)`` path pays the planning cost once per
    (config, shape, stitch, phase, regime).

    Serving phases take ``kv_len`` (the cache extent the attention
    core reads — defaults to ``seq``) and, for paged serving,
    ``paged`` = the KV page size; both join the plan fingerprint.
    ``"forward"`` plans are cache-free and ignore/normalize both.

    Robustness: an unreadable record is quarantined to ``*.corrupt``
    by ``load_plan``; a record that parses but whose payload is
    mangled is quarantined here the same way, then re-carved once — a
    relaunch must not re-parse known-bad bytes forever.  A *stale*
    ``PLANNER_VERSION`` is neither: the record stays in place and a
    fresh plan is carved beside it."""
    if not plannable(cfg):
        raise ValueError(f"config {cfg.name!r} is not plannable")
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} not in {PHASES}")
    if phase == "forward":
        paged = kv_len = None
    elif kv_len is None:
        kv_len = seq
    key = plan_key(cfg, batch, seq, stitch, hw, mesh, phase, paged,
                   kv_len)
    plan = _PLAN_MEMO.get(key)
    if plan is not None:
        return plan
    if use_cache:
        rec = schedule_cache.load_plan(key, hw)
        if rec is not None:
            try:
                plan = plan_from_json(rec)
            except (KeyError, ValueError, TypeError):
                # parsed as JSON but the payload is mangled:
                # quarantine the evidence and re-carve once
                schedule_cache._quarantine_corrupt(
                    schedule_cache.plan_entry_path(key, hw))
                plan = None
            if plan is not None and plan.version == PLANNER_VERSION:
                _PLAN_MEMO[key] = plan
                return plan
    layer = _carve_and_stitch(cfg, batch, seq, stitch=stitch, hw=hw,
                              mesh=mesh, phase=phase, kv_len=kv_len)
    plan = Plan(version=PLANNER_VERSION, config=cfg.name, batch=batch,
                seq=seq, dtype=cfg.dtype, stitch=bool(stitch),
                mesh=mesh.canonical() if mesh is not None else None,
                n_layers=cfg.n_layers, layer=layer, phase=phase,
                paged=paged, kv_len=kv_len)
    if use_cache:
        schedule_cache.store_plan(key, hw, plan_to_json(plan))
    _PLAN_MEMO[key] = plan
    return plan


# ---------------------------------------------------------------------------
# JSON (de)serialization — the persisted/golden-fixture form
# ---------------------------------------------------------------------------

def plan_to_json(plan: Plan) -> dict:
    return {
        "version": plan.version,
        "config": plan.config,
        "batch": plan.batch,
        "seq": plan.seq,
        "dtype": plan.dtype,
        "stitch": plan.stitch,
        "mesh": _mesh_to_json(plan.mesh),
        "n_layers": plan.n_layers,
        "phase": plan.phase,
        "paged": plan.paged,
        "kv_len": plan.kv_len,
        "layer": {
            "nodes": [[n.name, n.kind, n.role, list(n.ins)]
                      for n in plan.layer.nodes],
            "chains": [{
                "kind": c.kind, "ops": list(c.ops), "fused": c.fused,
                "ai": c.ai,   # doubles round-trip exactly through JSON
                "prologue": list(c.prologue),
                "epilogue": list(c.epilogue),
            } for c in plan.layer.chains],
            "glue": list(plan.layer.glue),
            "dropped": list(plan.layer.dropped),
        },
    }


def plan_from_json(data: dict) -> Plan:
    lay = data["layer"]
    layer = LayerPlan(
        nodes=tuple(OpNode(str(n), str(k), str(r), tuple(ins))
                    for n, k, r, ins in lay["nodes"]),
        chains=tuple(CarvedChain(kind=str(c["kind"]),
                                 ops=tuple(c["ops"]),
                                 fused=bool(c["fused"]),
                                 ai=float(c["ai"]),
                                 prologue=tuple(c["prologue"]),
                                 epilogue=tuple(c["epilogue"]))
                     for c in lay["chains"]),
        glue=tuple(lay["glue"]),
        dropped=tuple(lay["dropped"]))
    # "phase" is read strictly: a pre-v2 record raises KeyError here,
    # which plan_model treats as stale and re-plans.
    return Plan(version=int(data["version"]), config=str(data["config"]),
                batch=int(data["batch"]), seq=int(data["seq"]),
                dtype=str(data["dtype"]), stitch=bool(data["stitch"]),
                mesh=_mesh_from_json(data["mesh"]),
                n_layers=int(data["n_layers"]), layer=layer,
                phase=str(data["phase"]),
                paged=(None if data["paged"] is None
                       else int(data["paged"])),
                kv_len=(None if data["kv_len"] is None
                        else int(data["kv_len"])))


def _mesh_to_json(canonical):
    if canonical is None:
        return None

    def conv(x):
        if isinstance(x, tuple):
            return ["t", [conv(v) for v in x]]
        return x

    return conv(canonical)


def _mesh_from_json(data):
    if data is None:
        return None

    def conv(x):
        if isinstance(x, list) and len(x) == 2 and x[0] == "t":
            return tuple(conv(v) for v in x[1])
        return x

    return conv(data)


# ---------------------------------------------------------------------------
# Pricing — eq (2') comparison against the hand-wired layout
# ---------------------------------------------------------------------------

def _roofline_seconds(chain: Chain, hw: "TpuSpec | GpuSpec",
                      mesh: Optional[MeshSpec]) -> float:
    """One kernel's roofline time: a fused pass over the chain (inputs
    read once, outputs written once)."""
    local = mesh.localize(chain) if mesh is not None else chain
    return max(local.fused_io_bytes() / hw.hbm_bw,
               local.total_flops() / chain_peak_flops(local, hw))


def _glue_elems(node: OpNode, cfg, batch: int, seq: int,
                kv_len: Optional[int] = None) -> dict:
    """(read, write) element traffic of one standalone glue kernel."""
    d, dh = cfg.d_model, cfg.dh
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    tok = batch * seq
    kv = kv_len if kv_len is not None else seq
    if node.role == "norm":
        return {"rw": 2 * tok * d, "extra": d}
    if node.role == "qk_norm":
        h = hq if node.name.endswith("_q") else hkv
        return {"rw": 2 * tok * h * dh, "extra": dh}
    if node.role == "rope":
        h = hq if node.name.endswith("_q") else hkv
        return {"rw": 2 * tok * h * dh, "extra": seq * dh}
    if node.role == "softmax":
        return {"rw": 2 * batch * hq * seq * kv, "extra": 0}
    if node.role == "residual":
        return {"rw": 3 * tok * d, "extra": 0}
    if node.role == "kv_write":
        # read this step's k and v, write both through to the cache
        return {"rw": 4 * tok * hkv * dh, "extra": 0}
    # gate_act: read gate (+up), write hidden
    n_in = 2 if gated(cfg) else 1
    return {"rw": (n_in + 1) * tok * cfg.d_ff, "extra": 0}


def _glue_standalone_seconds(node: OpNode, cfg, batch: int, seq: int,
                             hw: "TpuSpec | GpuSpec",
                             kv_len: Optional[int] = None) -> float:
    e = _glue_elems(node, cfg, batch, seq, kv_len)
    dtb = DTYPE_BYTES[cfg.dtype]
    return (e["rw"] * dtb + e["extra"] * 4) / hw.hbm_bw


def _glue_stitched_seconds(node: OpNode, cfg, batch: int, seq: int,
                           hw: "TpuSpec | GpuSpec",
                           kv_len: Optional[int] = None) -> float:
    """Stitched glue pays only its EXTRA operand traffic (residual
    stream read, rope tables, norm scales); the main operand stays
    on chip and its output write replaces the host chain's — that saved
    round trip is the whole point of FusionStitching."""
    dtb = DTYPE_BYTES[cfg.dtype]
    extra = _glue_elems(node, cfg, batch, seq, kv_len)["extra"] * 4
    if node.role == "residual":
        extra += batch * seq * cfg.d_model * dtb
    return extra / hw.hbm_bw


def price_plan(plan: Plan, cfg, *, hw: "TpuSpec | GpuSpec" = H100,
               mesh: Optional[MeshSpec] = None, seed: int = 0) -> dict:
    """Price one block of ``plan`` under eq (2') and compare with the
    hand-wired layout (fused attention + unfused MLP + standalone
    glue — what ``models/layers.py`` executes).

    Fused chains are priced by the tuner (``api.fuse_attention`` /
    ``api.fuse_attention_paged`` / ``api.fuse_mlp_chain``, both cache
    levels apply) and *demoted* to their unfused alternative when the
    search's eq (2') time does not beat it — so ``planner_seconds <=
    hand_seconds`` holds by construction.

    Serving plans price phase-faithfully: the attention kv extent is
    ``plan.kv_len`` (the cache length) and a paged plan routes through
    the paged tuner, whose report already includes the page-gather
    term; the ``kv_write`` write-through prices standalone on *both*
    sides (planner and hand-wired execute the identical scatter).
    """
    from . import api
    from .perf_model import paged_gather_seconds

    batch, seq = plan.batch, plan.seq
    kv = plan.kv_len if plan.kv_len is not None else seq
    # The MLP's shape as priced.  The executor flattens the tokens to
    # M = B*S at batch 1 (``layers.run_planned_layer``, ``ops.mlp_chain``
    # and ``layers.mlp_block`` alike), reading the shared weights once;
    # under ``GpuSpec`` both MLP sides are priced so.  ``TpuSpec`` keeps
    # the reference's (seq, batch=batch), which charges the weights once
    # a request, so that the V5E prices stay the reference's.
    mlp_b, mlp_s = ((1, batch * seq) if isinstance(hw, GpuSpec)
                    else (batch, seq))
    nodes = {n.name: n for n in plan.layer.nodes}
    templates = {ops: (kind, ch)
                 for kind, ops, ch in _template_chains(cfg, batch, seq,
                                                       plan.kv_len)
                 if kind != "mlp"}
    templates.update({ops: (kind, ch) for kind, ops, ch
                      in _template_chains(cfg, mlp_b, mlp_s, plan.kv_len)
                      if kind == "mlp"})

    def tuned_seconds(kind: str, ch_ops: tuple[str, ...]) -> float:
        if kind == "attention" and plan.paged is not None:
            tk = api.fuse_attention_paged(
                seq, kv, cfg.dh, cfg.dh, page_size=plan.paged,
                heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, batch=batch,
                dtype=cfg.dtype,
                causal=True, window=cfg.window, hw=hw, mesh=mesh,
                seed=seed)
        elif kind == "attention":
            tk = api.fuse_attention(
                seq, kv, cfg.dh, cfg.dh, heads=cfg.n_heads, batch=batch,
                dtype=cfg.dtype, causal=True, window=cfg.window, hw=hw,
                mesh=mesh, seed=seed)
        else:
            tk = api.fuse_mlp_chain(
                mlp_s, cfg.d_ff, cfg.d_model, batch=mlp_b, dtype=cfg.dtype,
                gated=gated(cfg), act=act_name(cfg), hw=hw, mesh=mesh,
                seed=seed)
        return tk.report.best_time

    def unfused_alt_seconds(kind: str) -> float:
        b_, s_ = (batch, seq) if kind == "attention" else (mlp_b, mlp_s)
        t = sum(_roofline_seconds(ch, hw, mesh)
                for _, ch in _split_chains(kind, cfg, b_, s_,
                                           plan.kv_len))
        interior = "softmax" if kind == "attention" else "act_gate"
        t += _glue_standalone_seconds(nodes[interior], cfg, batch, seq,
                                      hw, plan.kv_len)
        if kind == "attention" and plan.paged is not None:
            # the unfused split still reads the cache through the page
            # tables — same gather surcharge the paged tuner prices
            _, attn_ch = next(
                (k, c) for k, ops, c
                in _template_chains(cfg, batch, seq, plan.kv_len)
                if k == "attention")
            t += paged_gather_seconds(attn_ch, plan.paged, hw=hw,
                                      mesh=mesh)
        return t

    per_chain: dict[str, dict] = {}
    planner_seconds = 0.0
    for c in plan.layer.chains:
        name = "+".join(c.ops)
        if c.fused:
            fused_t = tuned_seconds(c.kind, c.ops)
            alt_t = unfused_alt_seconds(c.kind)
            chosen = min(fused_t, alt_t)
            per_chain[name] = {"kind": c.kind, "fused_seconds": fused_t,
                               "unfused_seconds": alt_t,
                               "demoted": alt_t < fused_t,
                               "seconds": chosen}
        else:
            _, ch = templates.get(c.ops) or (None, None)
            if ch is None:   # split-out singleton: rebuild its chain
                splits = dict(
                    _split_chains("attention", cfg, batch, seq,
                                  plan.kv_len)
                    + _split_chains("mlp", cfg, mlp_b, mlp_s,
                                    plan.kv_len))
                ch = splits[c.ops]
            chosen = _roofline_seconds(ch, hw, mesh)
            per_chain[name] = {"kind": c.kind, "seconds": chosen}
        planner_seconds += chosen

    glue_seconds = 0.0
    for g in plan.layer.glue:
        glue_seconds += _glue_standalone_seconds(nodes[g], cfg, batch,
                                                 seq, hw, plan.kv_len)
    for g in plan.layer.stitched():
        glue_seconds += _glue_stitched_seconds(nodes[g], cfg, batch,
                                               seq, hw, plan.kv_len)
    planner_seconds += glue_seconds

    # hand-wired: fused attention, everything else unfused, all glue
    # standalone (models/layers.py::paged_attention_block + mlp_block)
    hand = tuned_seconds("attention", ("qk", "softmax", "pv"))
    hand = min(hand, unfused_alt_seconds("attention"))
    for ops, (kind, ch) in templates.items():
        if kind == "attention":
            continue
        if kind == "mlp":
            hand += unfused_alt_seconds("mlp")
            continue
        hand += _roofline_seconds(ch, hw, mesh)
    for n in plan.layer.nodes:
        if n.kind == "glue" and n.name not in ("softmax", "act_gate"):
            hand += _glue_standalone_seconds(n, cfg, batch, seq, hw,
                                             plan.kv_len)

    return {
        "planner_seconds": planner_seconds,
        "hand_seconds": hand,
        "glue_seconds": glue_seconds,
        "chains": per_chain,
        "n_layers": plan.n_layers,
    }
