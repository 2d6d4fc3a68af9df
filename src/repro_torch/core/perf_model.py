"""Analytical performance model (§IV-A, eqs (2)–(5)) on GPU or TPU
constants.

    t_estm = (t_mem + t_comp) * alpha + t_coll             (2')
    t_mem  = Σ_loads/stores  bytes_per_visit * trips / W   (3)
    t_comp = Σ_computes      flops_per_visit * trips / P   (4)
    alpha  = (N_grid + N_extra) / N_grid                   (5')

Under ``GpuSpec`` (the port's target) ``N_extra`` is the SM count: the
paper's own occupancy slowdown (N_block + N_SM)/N_block — a grid of few
thread blocks leaves SMs idle.  Under ``TpuSpec`` (kept for parity with
the JAX package) it is the pipeline depth: a Pallas grid runs on one
TensorCore as a software pipeline whose fill/drain few grid steps do
not amortize.

Rule 4's on-chip budget differs the same way: ``TpuSpec`` bounds
per-grid-step VMEM residency with the paper's 1.2 slack
(``vmem_estimate``); ``GpuSpec`` bounds the shared memory one thread
block holds, hard (``smem_estimate``), with the attention chain priced
by the exact footprint of the CUDA kernel that runs it
(``attention_smem_bytes``).

The ``t_coll`` term in (2') is this repo's mesh extension
(docs/design.md §7, docs/tuning.md): under a ``MeshSpec`` the model
prices the *local shard's* tile trips (eqs (3)/(4) on the localized
chain) plus the ring-collective time needed to combine partial results
across sharded reduction loops.  With no mesh — or a 1×1 mesh —
``t_coll`` is 0 and (2') degenerates to the paper's eq (2) exactly.

VMEM estimation mirrors the paper's eq. (1) shared-memory estimate with
a 2x double-buffer factor on pipelined input tiles (Mosaic allocates
two copies of every streamed block).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from .chain import Chain, DTYPE_BYTES
from .dag import Schedule
from .ring import (ICI_HOP_LATENCY_S, pipelined_overlap_seconds,
                   ring_traffic_bytes)

# Bump whenever the analytical model's *output* can change for a fixed
# (chain, tile assignment, mesh) — new terms, retuned constants, changed
# hoisting semantics.  core.schedule_cache folds this into every disk
# key, so persisted schedules from an older model never resurface.
MODEL_VERSION = 4


@dataclass(frozen=True)
class TpuSpec:
    """TPU v5e (the production target in this repo)."""

    name: str = "tpu_v5e"
    peak_flops: float = 197e12        # bf16 MXU peak (P)
    hbm_bw: float = 819e9             # bytes/s (W)
    vmem_bytes: int = 128 * 1024 * 1024
    ici_bw: float = 50e9              # bytes/s per link
    mxu_align: int = 128              # lane width; matmul tile unit
    sublane: int = 8
    pipeline_stages: int = 2          # double buffering (alpha, eq 5')
    vmem_slack: float = 1.2           # paper's Rule-4 estimation slack
    n_cores: int = 1                  # v5e: 1 TensorCore per chip

    @property
    def tile_unit(self) -> int:
        return self.mxu_align

    @property
    def alpha_extra(self) -> int:
        return self.pipeline_stages

    @property
    def load_buffers(self) -> int:
        return 2                      # Mosaic double-buffers every input

    @property
    def rule4_budget(self) -> float:
        return self.vmem_slack * self.vmem_bytes


V5E = TpuSpec()

# fp32 path (interpret-mode / CPU correlation experiments use fp32)
V5E_F32 = TpuSpec(name="tpu_v5e_f32", peak_flops=197e12 / 4)


@dataclass(frozen=True)
class GpuSpec:
    """NVIDIA H100 SXM, the port's target.

    Datasheet values (NVIDIA H100 data sheet and Hopper white paper),
    to be replaced by measured ones once the port's benchmark exists.
    """

    name: str = "h100_sxm"
    peak_flops: float = 989e12        # bf16 dense tensor-core peak (P)
    peak_flops_f32: float = 67e12     # f32 outside the tensor cores
    hbm_bw: float = 3.35e12           # bytes/s (W)
    smem_per_block: int = 232_448     # 227 KB opt-in dynamic smem
    n_sm: int = 132
    tile_unit: int = 16               # tensor-core granularity (paper's)

    @property
    def alpha_extra(self) -> int:
        return self.n_sm

    @property
    def load_buffers(self) -> int:
        return 1                      # the simple kernels stage once

    @property
    def rule4_budget(self) -> float:
        return float(self.smem_per_block)


H100 = GpuSpec()


@dataclass(frozen=True)
class MeshSpec:
    """Parallelism regime the tuner prices (docs/design.md §7).

    axes:       ((mesh axis name, size), ...) — the physical mesh shape.
    placement:  ((chain loop, mesh axis), ...) — which cross-tile loop
                each sharded mesh axis splits.  A loop absent from the
                placement is fully local; an axis may appear at most
                once (1-D sharding per loop, matching ``dist.sharding``).
    batch_axes: mesh axes the chain's leading batch dim shards over
                (data parallelism — free of collectives for a fused
                kernel, but it shrinks the local grid, which moves alpha
                and therefore the best tile).
    ici_bw:     bytes/s per inter-chip link (ring model, v5e default).
    pipelined:  price the cross-shard combine as the software-pipelined
                ring (per-hop collective-permutes overlapped with tile
                compute, ``t_coll_pipelined``) instead of the serial
                blocking all-reduce (``t_coll``).  Localization is
                identical; only the collective term — and therefore the
                regime ranking and the schedule-cache key — differs.
    """

    axes: tuple[tuple[str, int], ...] = ()
    placement: tuple[tuple[str, str], ...] = ()
    batch_axes: tuple[str, ...] = ()
    ici_bw: float = V5E.ici_bw
    pipelined: bool = False

    @classmethod
    def single(cls) -> "MeshSpec":
        """The single-chip regime: estimate() must reproduce eq (2)."""
        return cls()

    @classmethod
    def from_mesh(cls, mesh, placement: tuple[tuple[str, str], ...] = (),
                  batch_axes: tuple[str, ...] = (),
                  ici_bw: float = V5E.ici_bw) -> "MeshSpec":
        """Build from anything with a ``.shape`` mapping (a jax Mesh)."""
        return cls(axes=tuple((str(a), int(s))
                              for a, s in dict(mesh.shape).items()),
                   placement=tuple(placement),
                   batch_axes=tuple(batch_axes), ici_bw=ici_bw)

    # ------------------------------------------------------------------
    def axis_size(self, name: str) -> int:
        for a, s in self.axes:
            if a == name:
                return s
        raise KeyError(f"mesh axis {name!r} not in {self.axes}")

    @property
    def n_devices(self) -> int:
        return math.prod(s for _, s in self.axes) if self.axes else 1

    def loop_factor(self, loop: str) -> int:
        """How many ways a chain loop is split across the mesh."""
        return math.prod(self.axis_size(a) for l, a in self.placement
                         if l == loop)

    def batch_factor(self) -> int:
        return math.prod(self.axis_size(a) for a in self.batch_axes)

    @property
    def is_single(self) -> bool:
        return (self.batch_factor() == 1
                and all(self.axis_size(a) == 1 for _, a in self.placement))

    def canonical(self) -> tuple:
        """Everything the tuner's output depends on, mesh-wise:
        localization is a function of per-loop split factors and the
        batch factor; the collective term of eq (2') prices each
        (placed loop, axis size) ring separately.  Two MeshSpecs with
        equal canonical forms yield identical searches — e.g. a 2x4 and
        a 4x2 mesh sharding the same loop 4-ways — so this (not the raw
        spec) keys the persistent schedule cache."""
        return (tuple(sorted((l, self.axis_size(a))
                             for l, a in self.placement
                             if self.axis_size(a) > 1)),
                self.batch_factor(), self.ici_bw, self.pipelined)

    def localize(self, chain: Chain) -> Chain:
        """The per-shard sub-problem: every placed loop's extent divided
        by its mesh factor (ceil — ragged shards are padded), batch by
        the batch_axes product.  Identity for a 1×1 mesh."""
        if self.is_single:
            return chain
        loops = {l: max(1, math.ceil(e / self.loop_factor(l)))
                 for l, e in chain.loops.items()}
        batch = max(1, math.ceil(chain.batch / self.batch_factor()))
        return dataclasses.replace(chain, loops=loops, batch=batch)


def _reduced_outputs(chain: Chain, loop: str) -> tuple[str, ...]:
    """Chain outputs whose value transitively accumulates a reduction
    over ``loop`` — sharding that loop leaves per-shard partial sums,
    so these outputs must be combined across the axis."""
    partial: set[str] = set()
    for op in chain.ops:
        if loop in op.reduce_dims or any(t in partial for t in op.ins):
            partial.add(op.out)
    return tuple(n for n in chain.output_names if n in partial)


def collective_bytes(chain: Chain, mesh: MeshSpec) -> float:
    """Per-device ring traffic to combine one fused-kernel invocation's
    partial results (docs/tuning.md).  ``chain`` must be the *local*
    chain (what each shard computes), so output bytes are shard-sized.

    Sharding a spatial loop is collective-free (outputs stay sharded);
    sharding a reduction loop all-reduces every downstream output over
    that axis.  An online-softmax producer upstream (attention's n loop)
    additionally moves the running (max, sum) statistics — one f32 pair
    per output row — to rescale the partials (FlashDecoding-style
    combine; same wire pattern as ``models.layers.
    distributed_decode_attention``)."""
    total = 0.0
    for loop, axis in mesh.placement:
        n = mesh.axis_size(axis)
        if n <= 1:
            continue
        outs = _reduced_outputs(chain, loop)
        softmax_upstream = any(op.epilogue == "online_softmax"
                               and (loop in op.reduce_dims
                                    or loop in chain.tensors[op.out].dims)
                               for op in chain.ops)
        for name in outs:
            t = chain.tensors[name]
            nbytes = (math.prod(chain.loops[d] for d in t.dims)
                      * t.dtype_bytes * chain.batch)
            total += ring_traffic_bytes("all-reduce", nbytes, n)
            if softmax_upstream:
                rows = chain.batch * math.prod(
                    chain.loops[d] for d in t.dims[:-1])
                total += ring_traffic_bytes("all-reduce", 2 * 4 * rows, n)
    return total


def t_coll(sched: Schedule, mesh: MeshSpec) -> float:
    """Collective seconds for the local schedule under ``mesh``."""
    return collective_bytes(sched.chain, mesh) / mesh.ici_bw


def _pipelined_ring_terms(chain: Chain, mesh: MeshSpec):
    """Per (placed reduction loop, reduced output) wire quantities of
    the pipelined ring combine — shared by the bytes accounting and the
    seconds model so the HLO assert and eq (2') can never drift.

    Yields ``(n, out_bytes, rows, softmax)`` where ``out_bytes`` is the
    shard-local combined output and ``rows`` its leading-dim row count
    (one f32 max + one f32 sum statistic per row when ``softmax``)."""
    for loop, axis in mesh.placement:
        n = mesh.axis_size(axis)
        if n <= 1:
            continue
        outs = _reduced_outputs(chain, loop)
        softmax = any(op.epilogue == "online_softmax"
                      and (loop in op.reduce_dims
                           or loop in chain.tensors[op.out].dims)
                      for op in chain.ops)
        for name in outs:
            t = chain.tensors[name]
            nbytes = (math.prod(chain.loops[d] for d in t.dims)
                      * t.dtype_bytes * chain.batch)
            rows = chain.batch * math.prod(
                chain.loops[d] for d in t.dims[:-1])
            yield n, nbytes, rows, softmax


def pipelined_collective_bytes(chain: Chain, mesh: MeshSpec) -> float:
    """Per-device wire bytes of the *pipelined* ring combine
    (docs/tuning.md): the serial all-reduce decomposed into per-hop
    ``collective-permute``s a compiler can overlap with tile compute.

    Per reduced output over an ``n``-way ring: a balanced ring
    reduce-scatter moves the chunked partial state — the output plus,
    under an online-softmax producer, the f32 running-sum statistic —
    over ``n - 1`` hops of ``1/n`` each, the owner finalizes its chunk,
    and a ring all-gather broadcasts the finished chunks over another
    ``n - 1`` hops.  The running max still needs one global ``pmax``
    (all-reduce) before any rescale can happen, exactly as the serial
    combine.  These are the collectives ``dist.ring_dispatch`` executes
    with ``pipelined=True``; the wire-level harness asserts the parsed
    HLO matches this figure byte-for-byte."""
    total = 0.0
    for n, nbytes, rows, softmax in _pipelined_ring_terms(chain, mesh):
        # reduce-scatter hops: output chunks (+ f32 sum-stat chunks)
        total += (n - 1) * ring_traffic_bytes(
            "collective-permute", nbytes / n, n)
        if softmax:
            total += (n - 1) * ring_traffic_bytes(
                "collective-permute", 4.0 * rows / n, n)
            # the global running max cannot ride the ring — every
            # shard's rescale needs it up front
            total += ring_traffic_bytes("all-reduce", 4.0 * rows, n)
        # all-gather hops: finalized output chunks
        total += (n - 1) * ring_traffic_bytes(
            "collective-permute", nbytes / n, n)
    return total


def t_coll_pipelined(chain: Chain, mesh: MeshSpec, tile_s: float) -> float:
    """Additive collective seconds of the pipelined ring combine — the
    eq (2') term that replaces ``t_coll`` when ``mesh.pipelined``.

    ``tile_s`` is the shard's full tile time; chunked ``n`` ways it
    yields ``hop_compute = tile_s / n`` per reduce-scatter hop, so the
    steady state costs ``pipelined_overlap_seconds`` (``max(hop_compute,
    hop_wire) * (n - 1)``, core.ring).  Relative to the serial model —
    which already charges ``tile_s`` in the tile terms — the *extra*
    seconds are::

        (n-1) * (max(hc, hw_rs) - hc)     exposed RS wire (0 when
                                          compute hides every hop)
      + (n-1) * hw_ag                     all-gather drain (no compute
                                          left to hide behind)
      + t_pmax                            global-max all-reduce
      + 2 * (n-1) * ICI_HOP_LATENCY_S     per-hop launch tax

    The hop tax is what the serial combine avoids (one fused
    all-reduce), so wire-dominated short shapes still price serial
    cheaper — the crossover the regime search exploits."""
    total = 0.0
    for n, nbytes, rows, softmax in _pipelined_ring_terms(chain, mesh):
        hc = tile_s / n
        state = nbytes + (4.0 * rows if softmax else 0.0)
        hw_rs = state / n / mesh.ici_bw
        hw_ag = nbytes / n / mesh.ici_bw
        total += (pipelined_overlap_seconds(hc, hw_rs, n) - (n - 1) * hc
                  + (n - 1) * hw_ag
                  + 2 * (n - 1) * ICI_HOP_LATENCY_S)
        if softmax:
            total += ring_traffic_bytes("all-reduce", 4.0 * rows,
                                        n) / mesh.ici_bw
    return total


# ---------------------------------------------------------------------------
# Paged-KV serving extension (docs/serving.md)
# ---------------------------------------------------------------------------

PAGE_TABLE_ENTRY_BYTES = 4   # int32 physical-page index


def paged_gather_bytes(chain: Chain, page_size: int,
                       mesh: "MeshSpec | None" = None) -> float:
    """Extra HBM traffic the paged-KV regime adds to one attention
    call (docs/serving.md — the paged extension of eq (2')).

    A paged cache cannot be streamed contiguously: the kernel reaches
    K/V through the page-table indirection, so each shard's local kv
    is read page-by-page and staged into the contiguous layout the
    fused schedule consumes — one read of the pages plus one write of
    the staged block (2x local kv bytes) — and the page-table entries
    themselves cross HBM.  The kv extent rounds up to page granularity
    (a partly filled tail page still moves whole pages).  The term is
    tile-independent, so it never moves the tile search — only the
    regime ranking (``api.fuse_attention_paged_regimes``): under a
    kv-sharding placement each shard gathers only its ``n / shards``
    slice, which is exactly the localized chain's ``n``.

    ``chain`` must be an attention chain (tensors ``Kt``/``V``);
    heads fold into ``chain.batch`` as everywhere else in the model.
    """
    local = mesh.localize(chain) if mesh is not None else chain
    n = math.ceil(local.loops["n"] / page_size) * page_size
    row = (local.loops["k"] * local.tensors["Kt"].dtype_bytes
           + local.loops["h"] * local.tensors["V"].dtype_bytes)
    # every chain-batch row walks its own table slice (heads folded
    # into batch overcount the indirection by the head count, but the
    # term is 4 bytes against page_size*(K+H) kv bytes per entry)
    table = math.ceil(n / page_size) * PAGE_TABLE_ENTRY_BYTES * local.batch
    return 2.0 * n * row * local.batch + table


def paged_gather_seconds(chain: Chain, page_size: int,
                         hw: "TpuSpec | GpuSpec" = H100,
                         mesh: "MeshSpec | None" = None) -> float:
    return paged_gather_bytes(chain, page_size, mesh) / hw.hbm_bw


def t_mem(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100) -> float:
    total = 0.0
    for s in sched.stmts:
        if s.kind == "compute":
            continue
        tensor = sched.chain.tensors[s.tensor]
        bytes_per_visit = (sched.visit_elems(s, tensor.dims)
                          * tensor.dtype_bytes)
        total += bytes_per_visit * sched.trips(s)
    return total / hw.hbm_bw


def t_comp(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100) -> float:
    total = 0.0
    ops = {o.name: o for o in sched.chain.ops}
    for s in sched.stmts:
        if s.kind != "compute":
            continue
        op = ops[s.op]
        flops_per_visit = (op.flops_per_point
                           * sched.visit_elems(s, s.related))
        # alignment waste: a matmul dim below the tile unit (the MXU's
        # 128 lanes, a tensor core's 16) still occupies a full unit
        util = 1.0
        for d in s.related:
            sz = (sched.tile_sizes[d] if d in s.path
                  else sched.chain.loops[d])
            if sz < hw.tile_unit:
                util *= sz / hw.tile_unit
        total += flops_per_visit * sched.trips(s) / max(util, 1e-9)
    return total / hw.peak_flops


def alpha(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100) -> float:
    n_grid = max(1, sched.grid_size())
    return (n_grid + hw.alpha_extra) / n_grid


def estimate(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100,
             mesh: "MeshSpec | None" = None) -> float:
    """Eq (2'): estimated seconds for the fused kernel.

    With a mesh, ``sched`` is expected to already be a schedule over the
    localized chain (``heuristic_search`` localizes before candidate
    generation); the tile terms price the local block and the collective
    term prices the cross-shard combine.  mesh=None (or a 1×1 mesh)
    reproduces the paper's single-chip eq (2) exactly.
    """
    t = (t_mem(sched, hw) + t_comp(sched, hw)) * alpha(sched, hw)
    if mesh is not None and not mesh.is_single:
        t += (t_coll_pipelined(sched.chain, mesh, t) if mesh.pipelined
              else t_coll(sched, mesh))
    return t


def vmem_estimate(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100) -> int:
    """Paper eq (1) adapted: per-grid-step on-chip residency in bytes,
    each streamed input held ``hw.load_buffers`` times."""
    total = 0
    chain = sched.chain
    producers = chain.producers()
    for s in sched.stmts:
        tensor = chain.tensors[s.tensor]
        if s.kind == "load":
            tile = sched.visit_elems(s, tensor.dims) * tensor.dtype_bytes
            total += hw.load_buffers * tile
        elif s.kind == "store":
            total += sched.visit_elems(s, tensor.dims) * tensor.dtype_bytes
        elif s.kind == "compute":
            # fp32 accumulator for the produced tile
            tile_elems = 1
            for d in tensor.dims:
                tile_elems *= sched.tile_sizes[d]
            mult = sched.cached_intermediates.get(s.tensor, 1)
            total += tile_elems * mult * DTYPE_BYTES["float32"]
    return total


def is_attention(chain: Chain) -> bool:
    return any(op.epilogue == "online_softmax" for op in chain.ops)


def attention_smem_bytes(bq, bkv, d: int, dv: int, in_bytes: int):
    """Shared memory one thread block of the CUDA attention kernel
    (``kernels/csrc/attention_partial.cu``) allocates: the q, k and v
    tiles in the input type, the f32 score tile and output accumulator,
    and three f32 per-row statistics (running max, running sum, the
    rescale factor).  The kernel's wrapper checks launches against this
    same function, so a tile Rule 4 admits is a tile the kernel holds.
    ``bq``/``bkv`` may be numpy arrays (the batched model)."""
    return ((bq * d + bkv * d + bkv * dv) * in_bytes
            + (bq * bkv + bq * dv + 3 * bq) * 4)


def smem_estimate(sched: Schedule, hw: GpuSpec = H100) -> int:
    """Rule 4 under ``GpuSpec``: shared memory per thread block.  An
    attention chain runs as the CUDA kernel, which keeps k and h whole,
    so its footprint is ``attention_smem_bytes`` at the schedule's
    (m, n) tiles; a chain with no CUDA kernel yet is priced by eq (1)
    with every input staged once."""
    chain = sched.chain
    if is_attention(chain):
        ts = sched.tile_sizes
        return attention_smem_bytes(ts["m"], ts["n"], chain.loops["k"],
                                    chain.loops["h"],
                                    chain.tensors["Q"].dtype_bytes)
    return vmem_estimate(sched, hw)


def rule4_bytes(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100) -> int:
    """The residency Rule 4 compares against ``hw.rule4_budget``."""
    if isinstance(hw, GpuSpec):
        return smem_estimate(sched, hw)
    return vmem_estimate(sched, hw)
