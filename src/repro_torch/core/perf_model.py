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
block holds, hard (``smem_estimate``), with the attention and MLP
chains priced by the exact footprint of the CUDA kernels that run them
(``kernel_smem_bytes``).

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
import functools
import math
from dataclasses import dataclass

import numpy as np

from .chain import Chain, DTYPE_BYTES, PARTIAL_ATTENTION
from .dag import Schedule
from .ring import (ICI_HOP_LATENCY_S, pipelined_overlap_seconds,
                   ring_traffic_bytes)

# Bump whenever the analytical model's *output* can change for a fixed
# (chain, tile assignment, mesh) — new terms, retuned constants, changed
# hoisting semantics.  core.schedule_cache folds this into every disk
# key, so persisted schedules from an older model never resurface.
MODEL_VERSION = 7


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
    smem_per_sm: int = 233_472        # 228 KB: what co-resident blocks share
    smem_reserved: int = 1_024        # the runtime's own bytes per block
    threads_per_sm: int = 2_048
    n_sm: int = 132
    tile_unit: int = 16               # tensor-core granularity (paper's)
    ici_bw: float = 450e9             # NVLink 4 per direction (18 links)

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
        """Build from a ``DeviceMesh`` (its ``mesh_dim_names`` and
        ``shape``) or anything with a ``.shape`` mapping."""
        names = getattr(mesh, "mesh_dim_names", None)
        shape = (dict(zip(names, tuple(mesh.shape))) if names
                 else dict(mesh.shape))
        return cls(axes=tuple((str(a), int(s)) for a, s in shape.items()),
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
    _, extra = kernel_split_terms(sched.chain, sched.tile_sizes,
                                  "(" in sched.sub_expr(), hw)
    return (total + extra) / hw.hbm_bw


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
    """Eq (5'): N_grid is the schedule's grid (``Schedule.grid_size``)
    times the blocks a split adds to each grid point
    (``kernel_split_terms``: the MLP kernel's n splits under
    ``GpuSpec``)."""
    splits, _ = kernel_split_terms(sched.chain, sched.tile_sizes,
                                   "(" in sched.sub_expr(), hw)
    n_grid = max(1, sched.grid_size() * int(splits))
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
    t = ((t_mem(sched, hw) + t_comp(sched, hw)) * alpha(sched, hw)
         + chain_tie_break(sched.chain, sched.tile_sizes,
                           "(" in sched.sub_expr(), hw))
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


#: the bf16 tensor-core attention kernel: query rows per warp and the
#: most warps a block takes
MMA_ROWS = 16
MMA_MAX_WARPS = 8
#: keys one stage of a kernel's kv ring holds at least: whole kv tiles,
#: max(1, keys // bkv) of them (``kMmaStageKeys`` / ``kPartialStageKeys``;
#: the partial kernel's count is for bf16, half of it for f32)
MMA_STAGE_KEYS = 64
PARTIAL_STAGE_KEYS = 128


def kv_stage_tiles(keys: int, bkv):
    """kv tiles one stage of a kernel's 2-stage kv ring holds: as many
    as fit ``keys``, at least one.  ``bkv`` may be a numpy array."""
    t = keys // bkv
    return t + (t < 1) * (1 - t)            # max(t, 1), for arrays too


def attention_mma_bkv_max(dv: int) -> int:
    """Largest kv tile of the bf16 tensor-core kernel at head dim ``dv``:
    a thread holds dv / 2 O floats and the scores of a stage of the kv
    ring (at least ``MMA_STAGE_KEYS`` keys), keys / 2 floats, and the
    kernel's register buckets stop at 128 + 128 (dv <= 128) and
    256 + 64."""
    return 128 if dv <= 128 else 64


def mma_padded_bkv(bkv):
    """A kv tile of the bf16 tensor-core kernel as it lies in shared
    memory: padded to whole 16-key chunks (zero rows whose scores are
    -inf).  ``bkv`` may be a numpy array."""
    return -(-bkv // 16) * 16


def attention_tiles_ok(bq, bkv, d: int, dv: int, in_bytes: int):
    """The tile rule of the normalised entry (``fused_attention``): the
    bf16 tensor-core kernel takes head dims that are multiples of 16 up
    to 256, at most ``MMA_MAX_WARPS`` warps of ``MMA_ROWS`` query rows
    (bq <= 128; a bq that is no multiple of 16 is padded inside the
    kernel) and kv tiles up to ``attention_mma_bkv_max(dv)`` (one that
    is no multiple of 16 is padded inside the kernel).  The f32
    CUDA-core kernel takes any tile.  ``bq``/``bkv`` may be numpy
    arrays (the batched model)."""
    if in_bytes == 4:
        return (bq > 0) & (bkv > 0)
    if d % 16 or dv % 16 or d > 256 or dv > 256:
        return (bq < 0) & (bkv < 0)         # False, of the tiles' shape
    return ((bq <= MMA_ROWS * MMA_MAX_WARPS)
            & (bkv <= attention_mma_bkv_max(dv)))


def attention_smem_bytes(bq, bkv, d: int, dv: int, in_bytes: int):
    """Shared memory one thread block of the normalised attention kernel
    (``kernels/csrc/attention_partial.cu``, ``fused_attention``)
    allocates.  bf16 (tensor cores): the q tile, its rows rounded up to
    whole warps of 16, and a 2-stage ring of k and v, each stage
    ``kv_stage_tiles(MMA_STAGE_KEYS, bkvp)`` kv tiles of
    ``bkvp = mma_padded_bkv(bkv)`` rows, every row padded by 16 bytes.
    f32 (CUDA cores): the q, k and v tiles, the f32 score tile and
    output accumulator, and three f32 per-row statistics
    (running max, running sum, the rescale factor).  The kernel's
    wrapper checks launches against this same function, so a tile
    Rule 4 admits is a tile the kernel holds.  ``bq``/``bkv`` may be
    numpy arrays (the batched model)."""
    if in_bytes == 2:
        rows = -(-bq // MMA_ROWS) * MMA_ROWS
        bkvp = mma_padded_bkv(bkv)
        sk = kv_stage_tiles(MMA_STAGE_KEYS, bkvp) * bkvp
        return (rows * (d + 8) + 2 * sk * (d + 8) + 2 * sk * (dv + 8)) * 2
    return ((bq * d + bkv * d + bkv * dv) * in_bytes
            + (bq * bkv + bq * dv + 3 * bq) * 4)


def attention_partial_smem_bytes(bq, bkv, d: int, dv: int, in_bytes: int,
                                 group: int):
    """Shared memory one thread block of the partial attention kernel
    (``kernels/csrc/attention_partial.cu``, ``fused_attention_partial``)
    allocates: a 2-stage ring of k and v in the input type, each stage
    ``kv_stage_tiles(PARTIAL_STAGE_KEYS * 2 // in_bytes, bkv)`` kv
    tiles, every row padded by 16 bytes, and for the block's
    ``group * bq`` rows (the q tiles of one GQA group) q, the output
    accumulator and the stage's scores in f32, the running max and sum,
    and one rescale factor per kv tile of the stage.  The wrapper
    checks launches against this same function.  ``bq``/``bkv`` may be
    numpy arrays (the batched model)."""
    pad = 16 // in_bytes
    rows = group * bq
    tiles = kv_stage_tiles(PARTIAL_STAGE_KEYS * 2 // in_bytes, bkv)
    sk = tiles * bkv
    return (2 * sk * (d + dv + 2 * pad) * in_bytes
            + rows * (d + dv + sk + 2 + tiles) * 4)


def is_mlp(chain: Chain) -> bool:
    """A ``chain.mlp_chain``: its up-projection carries the activation
    epilogue (``gated_<act>`` or ``<act>``)."""
    return any(op.name == "mlp_up" and op.epilogue for op in chain.ops)


#: the MLP kernel (``kernels/csrc/mlp_chain.cu``): threads a block; the
#: bf16 kernel's cp.async ring, of as many stages as keep
#: ``MLP_RING_BYTES`` in flight within [MLP_MIN_STAGES, MLP_MAX_STAGES];
#: the E columns one chunk of its down-projection holds in registers
#: (32 a warp)
MLP_THREADS = 256
MLP_MIN_STAGES = 3
MLP_MAX_STAGES = 8
MLP_RING_BYTES = 65536
MLP_E_CHUNK = 256
#: the bf16 tensor-core kernel's register arrays: a warp holds up to 9
#: row groups of 16 rows (bm <= 144) for one 16-column group of an n
#: block, or up to 4 for two (bn <= 256)
MLP_MAX_ROW_GROUPS = 9
#: blocks an SM holds by registers: the launch bounds of the tensor-core
#: kernel (256, 1) and of the CUDA-core kernel (256, 2)
MLP_REG_BLOCKS = {True: 1, False: 2}
#: split counts ``mlp_splits`` weighs: up to this many blocks an SM
MLP_MAX_SPLITS_PER_SM = 2
#: what a ring step of the busiest SM adds to eq (2') for the GEMM
#: chains' bf16 kernels (``chain_tie_break``): far below any cost the
#: model tells apart, so it orders only schedules priced alike
CHAIN_TIE_S = 1.0e-15


def _at_least(x, lo):
    """max(x, lo) for ints and numpy arrays alike."""
    return x + (x < lo) * (lo - x)


def _at_most(x, hi):
    """min(x, hi) for ints and numpy arrays alike."""
    return x - (x > hi) * (x - hi)


def _ceil16(x):
    return -(-x // 16) * 16


def mlp_tensor_cores(a_bytes: int, w_bytes: int) -> bool:
    """Whether the MLP kernel runs its products on tensor cores: A and
    the weights both bf16.  Any f32 operand keeps CUDA-core arithmetic
    (f32 parity allows no TF32)."""
    return a_bytes == 2 and w_bytes == 2


def mlp_tiles_ok(bm, bn, n: int, a_bytes: int, w_bytes: int):
    """The tile rule of the MLP kernel.  The bf16 tensor-core kernel
    pads bm, bn and bk to whole 16s inside, but its 8 warps each hold
    the up-projection of one 16-column group of an n block for up to
    ``MLP_MAX_ROW_GROUPS`` row groups (bm <= 144, bn <= 128), or of two
    for up to 4 (bm <= 64, bn <= 256), in registers; and its hidden
    columns follow the n axis only when bn is a whole number of 16s (or
    one n block covers all of N).  The f32 CUDA-core kernel takes any
    tile.  Tiles may be numpy arrays (the batched model)."""
    if not mlp_tensor_cores(a_bytes, w_bytes):
        return (bm > 0) & (bn > 0)
    groups = -(-bm // 16)
    cols = -(-bn // 16)
    return ((groups <= MLP_MAX_ROW_GROUPS) & (cols <= 16)
            & ((groups <= 4) | (cols <= 8))
            & ((bn % 16 == 0) | (bn >= n)))


def mlp_ring(bm, bn, bk, gated: bool, held=None):
    """The bf16 kernel's cp.async ring at these tiles: (stages, bytes a
    stage, rows of Wd a down-projection stage holds).  A stage is the
    larger of an up-projection stage — the A tile (bm, bk) and the Wu
    (and Wg) tiles (bk, bn), bm, bn and bk padded to whole 16s and every
    row by 16 bytes — and a down-projection stage of Wd rows by
    ``MLP_E_CHUNK`` columns, whose rows are whole 16s, as many as fit
    the up stage (at least 16), so both phases keep about as many bytes
    in flight; there are as many stages as keep ``MLP_RING_BYTES`` in
    flight, within [MLP_MIN_STAGES, MLP_MAX_STAGES].  The GEMM chains
    pass the ``held`` bytes their block keeps beside the ring: their
    ring then gives up stages, down to two (double buffering), until
    ring and ``held`` fit a block; the MLP's ring never does.  The
    wrapper hands all three to the kernel.  Tiles may be numpy
    arrays."""
    nw = 2 if gated else 1
    bkp = _ceil16(bk)
    up = (_ceil16(bm) * (bkp + 8) + nw * bkp * (_ceil16(bn) + 8)) * 2
    rows = 16 * _at_least(up // (16 * (MLP_E_CHUNK + 8) * 2), 1)
    stage = _at_least(up, rows * (MLP_E_CHUNK + 8) * 2)
    stages = _at_most(_at_least(1 + -(-MLP_RING_BYTES // stage),
                                MLP_MIN_STAGES), MLP_MAX_STAGES)
    if held is not None:
        room = (H100.smem_per_block - held) // stage
        stages = _at_least(_at_most(stages, room), 2)
    return stages, stage, rows


def mlp_hidden_bytes(bm, bn, per=1):
    """The bf16 hidden tile of a split of ``per`` n blocks of ``bn``:
    (bm, per x bn), bm and bn padded to whole 16s and every row by 16
    bytes.  Tiles may be numpy arrays."""
    return _ceil16(bm) * (per * _ceil16(bn) + 8) * 2


def mlp_smem_bytes(bm, bn, bk, be, a_bytes: int, w_bytes: int,
                   gated: bool, per=1, squeeze: bool = False):
    """Shared memory one thread block of the CUDA MLP machine
    (``kernels/csrc/chain_mma.cuh``) allocates, for a split of ``per``
    n blocks of ``bn``.

    bf16 (tensor cores): the cp.async ring (``mlp_ring``; with
    ``squeeze``, the two-GEMM chain's, it gives up stages where it would
    not fit beside a hidden tile of one n block, so a tile that fits
    with the full ring keeps it and its splits), then the bf16 hidden
    tile of the whole split (``mlp_hidden_bytes``).  No E row is held on
    chip.  f32 (CUDA cores): the f32 up-projection accumulators (bm,
    bn), two when gated, the f32 E accumulator (bm, be) — ``be`` is
    ``bh`` for the deep class, the whole H for the flat class —, the A
    tile (bm, bk) in A's type and the weight tiles (bk, bn) in the
    weights' type; Wd is read straight from device memory.  The
    kernel's wrapper checks launches against this same function.  Tiles
    may be numpy arrays (the batched model)."""
    nw = 2 if gated else 1
    if mlp_tensor_cores(a_bytes, w_bytes):
        stages, stage, _ = mlp_ring(
            bm, bn, bk, gated, mlp_hidden_bytes(bm, bn) if squeeze else None)
        return stages * stage + mlp_hidden_bytes(bm, bn, per)
    return (nw * bm * bn * 4 + bm * be * 4 + bm * bk * a_bytes
            + nw * bk * bn * w_bytes)


def mlp_splits(batch: int, m: int, n: int, k: int, h: int, bm, bn, bk, be,
               a_bytes: int, w_bytes: int, gated: bool, hw=None,
               squeeze: bool = False):
    """(splits, n blocks per split) of the MLP kernel: the n axis cut
    into runs of whole ``bn`` blocks, none empty (the last may be
    shorter).  The one split rule: the wrapper launches it and the
    tuner prices it (eqs (2') and (5')).

    The grid has batch x m tiles x E tiles x splits blocks, of which
    ``slots`` run at once (as many as an SM's shared memory, threads and
    registers hold, on every SM).  A split count costs its waves times
    the blocks the busiest SM runs in a wave times the time of the
    longest run: each of its n blocks streams its Wu, Wg and Wd columns
    at the SM's share of the memory rate, or does its operations at the
    SM's share of the peak, whichever is longer (A is re-read from L2).
    More than one split adds the f32 partial E: splits x M x H x 4
    bytes, written once and read once by the merge.  A count whose
    hidden tile does not fit a block is out.  The cheapest count wins,
    the fewest splits among equals.  ``squeeze``: the layout's ring
    gives up stages to fit (``mlp_smem_bytes``), as the two-GEMM
    chain's does.  Tiles may be numpy arrays (the batched model);
    scalars return ints."""
    hw = H100 if hw is None else hw
    scalar = all(np.ndim(x) == 0 for x in (bm, bn, bk, be))
    if scalar:
        return _mlp_splits_scalar(batch, m, n, k, h, int(bm), int(bn),
                                  int(bk), int(be), a_bytes, w_bytes,
                                  gated, hw, squeeze)
    return _mlp_splits(batch, m, n, k, h, bm, bn, bk, be, a_bytes, w_bytes,
                       gated, hw, squeeze)


@functools.lru_cache(maxsize=65536)
def _mlp_splits_scalar(*args):
    splits, per = _mlp_splits(*args[:5], *(np.asarray([x]) for x in args[5:9]),
                              *args[9:])
    return int(splits[0]), int(per[0])


def _mlp_waves(blocks, smem, tc: bool, hw):
    """(waves, blocks the busiest SM runs in a wave) of a grid of
    ``blocks`` blocks of the MLP machine with ``smem`` bytes each: as
    many run at once on every SM as its shared memory, threads and
    registers hold."""
    per_sm = np.minimum(hw.smem_per_sm // (smem + hw.smem_reserved),
                        min(hw.threads_per_sm // MLP_THREADS,
                            MLP_REG_BLOCKS[tc]))
    slots = hw.n_sm * _at_least(per_sm, 1)
    return -(-blocks // slots), -(-np.minimum(blocks, slots) // hw.n_sm)


def _mlp_split_candidates(batch, m, n, k, h, bm, bn, bk, be, a_bytes,
                          w_bytes, gated, hw, squeeze=False):
    """(splits, per, seconds of the busiest SM's runs, seconds of the
    partial E) for every split count ``mlp_splits`` weighs, in rising
    order; a count whose hidden tile does not fit a block costs inf."""
    bm, bn, bk, be = (np.asarray(x, dtype=np.int64) for x in (bm, bn, bk, be))
    tc = mlp_tensor_cores(a_bytes, w_bytes)
    nw = 2 if gated else 1
    nb = -(-n // bn)
    blocks = batch * -(-m // bm) * -(-h // be)
    peak = hw.peak_flops if tc else hw.peak_flops_f32
    col_s = np.maximum((k * nw + be) * w_bytes / (hw.hbm_bw / hw.n_sm),
                       2.0 * bm * (k * nw + be) / (peak / hw.n_sm))
    block_s = bn * col_s                 # one n block on one SM
    partial_s = 2.0 * batch * m * h * 4 / hw.hbm_bw
    for s in range(1, min(int(nb.max()),
                          MLP_MAX_SPLITS_PER_SM * hw.n_sm) + 1):
        per = -(-nb // s)
        splits = -(-nb // per)
        smem = mlp_smem_bytes(bm, bn, bk, be, a_bytes, w_bytes, gated, per,
                              squeeze)
        waves, busiest = _mlp_waves(blocks * splits, smem, tc, hw)
        stream = np.where(smem > hw.smem_per_block, np.inf,
                          waves * busiest * per * block_s)
        yield splits, per, stream, (splits > 1) * splits * partial_s


def _mlp_splits(*args):
    best_cost = best_s = best_per = None
    for splits, per, stream, partial in _mlp_split_candidates(*args):
        cost = stream + partial
        if best_cost is None:
            best_cost, best_s, best_per = cost, splits, per
            continue
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_s = np.where(better, splits, best_s)
        best_per = np.where(better, per, best_per)
    return best_s, best_per


def mlp_split_costs(batch: int, m: int, n: int, k: int, h: int, bm: int,
                    bn: int, bk: int, be: int, a_bytes: int, w_bytes: int,
                    gated: bool, hw=None) -> dict:
    """What ``mlp_splits`` weighs at one tile: split count -> (seconds
    of the busiest SM's runs, seconds of the partial E)."""
    hw = H100 if hw is None else hw
    out = {}
    for splits, _, stream, partial in _mlp_split_candidates(
            batch, m, n, k, h, *(np.asarray([x]) for x in (bm, bn, bk, be)),
            a_bytes, w_bytes, gated, hw):
        out.setdefault(int(splits[0]), (float(stream[0]), float(partial[0])))
    return out


def mlp_partial_bytes(batch: int, m: int, h: int, splits):
    """Device-memory bytes the split adds: the f32 partial E of every
    split written once and read once by the merge (0 with one split).
    ``splits`` may be a numpy array."""
    return (splits > 1) * 2 * splits * batch * m * h * 4


GEMM_CHAIN_OPS = ("matmul_C", "matmul_E")
GEMM_CHAIN3_OPS = ("matmul_C", "matmul_E", "matmul_G")


def _chain3_held_bytes(bm, bn, n: int, h: int):
    """What the bf16 three-GEMM block holds beside its ring: C of all of
    N — (bm, N / bn blocks of bn), bm and bn padded to whole 16s and
    every row by 16 bytes — and the whole E row (bm, H), H padded the
    same way."""
    return _ceil16(bm) * (-(-n // bn) * _ceil16(bn) + 8 + _ceil16(h) + 8) * 2


def gemm_chain3_ring(bm, bn, bk, n: int, h: int):
    """The bf16 three-GEMM kernel's ring (``mlp_ring``, ungated), given
    up stages to fit beside C and the E row."""
    return mlp_ring(bm, bn, bk, False, _chain3_held_bytes(bm, bn, n, h))


def gemm_chain3_smem_bytes(bm, bn, bk, n: int, h: int, in_bytes: int):
    """Shared memory one thread block of the CUDA three-GEMM kernel
    (``kernels/csrc/gemm_chain.cu``, ``fused_gemm_chain3``) allocates.

    bf16 (tensor cores, ``chain3_mma_kernel``): the MLP machine's ring
    (``gemm_chain3_ring``), then C of all of N and the whole E row
    (``_chain3_held_bytes``); F comes through the ring.  f32 (CUDA
    cores): the f32 C accumulator (bm, bn), the f32 E row (bm, H), and
    the A (bm, bk) and B (bk, bn) tiles; D and F are read straight from
    device memory.  The wrapper checks launches against this same
    function.  Tiles may be numpy arrays."""
    if in_bytes == 2:
        stages, stage, _ = gemm_chain3_ring(bm, bn, bk, n, h)
        return stages * stage + _chain3_held_bytes(bm, bn, n, h)
    return (bm * bn + bm * h) * 4 + (bm * bk + bk * bn) * in_bytes


def on_mlp_machine(chain: Chain) -> bool:
    """Whether the MLP kernel's machine runs ``chain``: the MLP chain,
    and the two-GEMM chain as its ungated case with the identity
    activation."""
    return is_mlp(chain) or tuple(op.name for op in chain.ops) == \
        GEMM_CHAIN_OPS


def _weight_bytes(chain: Chain) -> int:
    """Bytes of an element of the chain's first weight (the MLP's Wu,
    a GEMM chain's B)."""
    return chain.tensors["Wu" if is_mlp(chain) else "B"].dtype_bytes


def chain_tie_break(chain: Chain, tiles: dict, flat: bool, hw):
    """A tie-break eq (2') adds for the GEMM chains' bf16 kernels under
    ``GpuSpec``: ``CHAIN_TIE_S`` for each ring step the busiest SM runs
    (its blocks in each wave, each running its up steps, n blocks x K /
    bk, and its down steps, E chunks x its n range / Wd rows a stage —
    and for the three-GEMM chain the G chunks x H / F rows a stage).
    Eq (2') prices their bn = 16 to 256 alike (the same bytes,
    operations and grid), and a narrow tile, on which most warps idle in
    the up phase, could win the tie; this orders tied schedules by their
    steps and nothing else.  0 for the MLP, attention, f32 and under
    ``TpuSpec``.  Tiles may be numpy arrays."""
    ops = tuple(op.name for op in chain.ops)
    if not (isinstance(hw, GpuSpec)
            and ops in (GEMM_CHAIN_OPS, GEMM_CHAIN3_OPS)):
        return 0.0
    nbytes = chain.tensors["A"].dtype_bytes
    if not mlp_tensor_cores(nbytes, _weight_bytes(chain)):
        return 0.0
    m, n, k, h = (chain.loops[d] for d in "mnkh")
    bm, bn, bk = tiles["m"], tiles["n"], tiles["k"]
    if ops == GEMM_CHAIN3_OPS:
        _, _, rows = gemm_chain3_ring(bm, bn, bk, n, h)
        steps = (-(-n // bn) * -(-k // bk)
                 + -(-h // MLP_E_CHUNK) * -(-_ceil16(n) // rows)
                 + -(-chain.loops["g"] // MLP_E_CHUNK)
                 * -(-_ceil16(h) // rows))
        blocks = chain.batch * -(-m // bm)
        smem = gemm_chain3_smem_bytes(bm, bn, bk, n, h, nbytes)
    else:
        be, splits, per = mlp_kernel_split(chain, tiles, flat, hw)
        _, _, rows = mlp_ring(bm, bn, bk, False)
        steps = (per * -(-k // bk) + -(-be // MLP_E_CHUNK)
                 * -(-_ceil16(_at_most(per * bn, n)) // rows))
        blocks = chain.batch * -(-m // bm) * -(-h // be) * splits
        smem = mlp_smem_bytes(bm, bn, bk, be, nbytes, nbytes, False, per,
                              True)
    waves, busiest = _mlp_waves(blocks, smem, True, hw)
    return waves * busiest * steps * CHAIN_TIE_S


def mlp_kernel_split(chain: Chain, tiles: dict, flat: bool, hw=None):
    """(E tile width, splits, n blocks per split) of the MLP machine
    that runs ``chain`` (``on_mlp_machine``) at ``tiles`` in the class
    ``flat`` — the split ``mlp_splits`` gives.  Tiles may be numpy
    arrays."""
    be = chain.loops["h"] if flat else tiles["h"]
    splits, per = mlp_splits(
        chain.batch, chain.loops["m"], chain.loops["n"], chain.loops["k"],
        chain.loops["h"], tiles["m"], tiles["n"], tiles["k"], be,
        chain.tensors["A"].dtype_bytes, _weight_bytes(chain),
        "Wg" in chain.tensors, hw, not is_mlp(chain))
    return be, splits, per


def kernel_smem_bytes(chain: Chain, tiles: dict, flat: bool, hw=None):
    """Shared memory of the CUDA kernel that runs ``chain`` at ``tiles``
    (loop -> tile, scalars or numpy arrays) in the schedule class
    ``flat`` (sub-expression ``n(k,h)``: the whole E row a block), or
    None for a chain no CUDA kernel runs.  Attention keeps the head
    dims whole whatever the class; the MLP machine's layout (the MLP and
    the two-GEMM chain) holds the hidden tile of its split
    (``mlp_splits`` on ``hw``, default H100); the three-GEMM kernel
    exists in the flat class only and holds C of all of N and the E
    row."""
    if is_attention(chain):
        args = (tiles["m"], tiles["n"], chain.loops["k"], chain.loops["h"],
                chain.tensors["Q"].dtype_bytes)
        if chain.name == PARTIAL_ATTENTION:
            return attention_partial_smem_bytes(*args, chain.group)
        return attention_smem_bytes(*args)
    if on_mlp_machine(chain):
        be, _, per = mlp_kernel_split(chain, tiles, flat, hw)
        return mlp_smem_bytes(tiles["m"], tiles["n"], tiles["k"], be,
                              chain.tensors["A"].dtype_bytes,
                              _weight_bytes(chain), "Wg" in chain.tensors,
                              per, not is_mlp(chain))
    if tuple(op.name for op in chain.ops) == GEMM_CHAIN3_OPS:
        return gemm_chain3_smem_bytes(tiles["m"], tiles["n"], tiles["k"],
                                      chain.loops["n"], chain.loops["h"],
                                      chain.tensors["A"].dtype_bytes)
    return None


def kernel_tiles_ok(chain: Chain, tiles: dict):
    """Whether the CUDA kernel that runs ``chain`` takes ``tiles`` at
    all, whatever they cost in shared memory: the tile rules of the
    normalised attention kernel (``attention_tiles_ok``) and of the MLP
    machine (``mlp_tiles_ok``: the MLP, two- and three-GEMM chains);
    every other kernel takes any tile.  Tiles may be numpy arrays (the
    batched model)."""
    if is_attention(chain) and chain.name != PARTIAL_ATTENTION:
        return attention_tiles_ok(tiles["m"], tiles["n"], chain.loops["k"],
                                  chain.loops["h"],
                                  chain.tensors["Q"].dtype_bytes)
    if on_mlp_machine(chain) or tuple(
            op.name for op in chain.ops) == GEMM_CHAIN3_OPS:
        return mlp_tiles_ok(tiles["m"], tiles["n"], chain.loops["n"],
                            chain.tensors["A"].dtype_bytes,
                            _weight_bytes(chain))
    return True


def kernel_split_terms(chain: Chain, tiles: dict, flat: bool, hw):
    """What a split of the reduction axis adds to eqs (2') and (5') for
    the CUDA kernel that runs ``chain`` under ``GpuSpec``: (blocks per
    grid point, device-memory bytes).  Only the MLP machine splits n
    (``mlp_splits``), for the MLP and the two-GEMM chain: its grid
    counts the splits and its traffic the partial E
    (``mlp_partial_bytes``); any other chain, and every chain under
    ``TpuSpec``, gets (1, 0).  Tiles may be numpy arrays."""
    if not (isinstance(hw, GpuSpec) and on_mlp_machine(chain)):
        return 1, 0
    _, splits, _ = mlp_kernel_split(chain, tiles, flat, hw)
    return splits, mlp_partial_bytes(chain.batch, chain.loops["m"],
                                     chain.loops["h"], splits)


def smem_estimate(sched: Schedule, hw: GpuSpec = H100) -> int:
    """Rule 4 under ``GpuSpec``: shared memory per thread block.  A
    chain with a CUDA kernel (attention, the MLP chain, the two- and
    three-GEMM chains) is priced by that kernel's own layout at the
    schedule's tiles and class (``kernel_smem_bytes``); any other chain
    by eq (1) with every input staged once."""
    smem = kernel_smem_bytes(sched.chain, sched.tile_sizes,
                             "(" in sched.sub_expr(), hw)
    return vmem_estimate(sched, hw) if smem is None else smem


def floor_residency_bytes(chain: Chain, tiles: dict,
                          hw: "TpuSpec | GpuSpec" = H100) -> int:
    """On-chip bytes of ``chain`` at one tile assignment, independent of
    any schedule — what the planner's stitch gate prices
    (``pruning.stitched_vmem_ok``).  Under ``TpuSpec`` every tensor's
    tile is resident and double-buffered (the JAX package's gate,
    bit for bit).  Under ``GpuSpec`` a chain with a CUDA kernel is priced
    by that kernel's layout in the deep class (the flat class only adds
    to it; the three-GEMM kernel is flat only), any other by every tile
    staged once."""
    if isinstance(hw, GpuSpec):
        smem = kernel_smem_bytes(chain, tiles, flat=False, hw=hw)
        if smem is not None:
            return smem
    resident = 0
    for t in chain.tensors.values():
        resident += math.prod(tiles[d] for d in t.dims) * t.dtype_bytes
    return resident * (hw.pipeline_stages if isinstance(hw, TpuSpec)
                       else hw.load_buffers)


def rule4_bytes(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100) -> int:
    """The residency Rule 4 compares against ``hw.rule4_budget``."""
    if isinstance(hw, GpuSpec):
        return smem_estimate(sched, hw)
    return vmem_estimate(sched, hw)


def rule4_ok(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100) -> bool:
    """Rule 4: the schedule's residency fits ``hw.rule4_budget`` and,
    under ``GpuSpec``, its CUDA kernel takes its tiles
    (``kernel_tiles_ok``)."""
    if isinstance(hw, GpuSpec) and not kernel_tiles_ok(sched.chain,
                                                       sched.tile_sizes):
        return False
    return rule4_bytes(sched, hw) <= hw.rule4_budget
