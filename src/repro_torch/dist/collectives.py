"""The explicit collectives of the port's mesh execution.

The JAX package's mesh programs are SPMD: XLA inserts an all-reduce, an
all-gather or a collective-permute wherever a layout changes.  Here
each rank runs its own eager program over its local shards, and the
model and the ring regimes call these functions at those places.

``Axis`` is one rank's view of one mesh dim: its size, its index along
it, its process group.  Every collective runs in that group through
``torch.distributed``.  Backends differ in which tensors they take:
NCCL takes CUDA tensors for every op; gloo takes CUDA tensors for
``all_reduce``, ``broadcast``, ``all_gather`` and ``reduce_scatter``
(it stages them through host memory itself) but not for
``send``/``recv``, which read the tensor's pointer as host memory.
Those ops go through ``via_host``, the one function that moves a
tensor through host memory, and it counts each such hop in
``HOST_HOPS``.  ``TRAFFIC`` counts every collective's payload, by op:
under gloo on one card all of it crosses host memory.

Under autograd (the training path) each collective of the model is one
of three conjugate pairs, ``torch.autograd.Function``s that the ``Axis``
methods ``gather``, ``reduce`` and ``enter`` apply:

* all-gather forward, reduce-scatter backward (``gather``): a sharded
  tensor gathered whole for consumers that differ by rank — the FSDP
  gather of a weight each data rank applies to its own batch, the kv
  heads each rank's q heads read — whose rank-partial gradients sum;
  with ``grad="own"`` the backward takes the rank's block of a gradient
  that every rank holds whole (a consumer replicated over the dim);
* all-reduce forward, identity backward (``reduce``): rank-partial
  sums made whole (a row-parallel output, the vocab-parallel loss's
  sums), whose gradient every rank already holds whole;
* identity forward, all-reduce backward (``enter``): a tensor
  replicated over the dim entering rank-specific columns (a block's
  normed input, the router and the qk-norm scales that act on this
  rank's heads or experts), whose gradient each rank holds only its
  part of.

and, for sequence parallelism, a fourth:

* reduce-scatter forward, all-gather backward (``scatter``): a
  row-parallel product's partial sums, summed and split over the
  sequence (the residual stream's layout between blocks).

``all_reduce`` and ``all_gather`` stay the inference forms (no
gradient).

``axis`` over several mesh dims at once (a batch over ``("pod",
"data")``) makes one process group over the ranks those dims span,
once per mesh and tuple of names.  A ``DryMesh`` starts no world: its
``DryAxis``es return tensors of the right shapes and types without a
process group, so that a step can be traced on the ``meta`` device as
one rank of a mesh of any size (``launch.dryrun``).  Every collective,
real or dry, is told to the taps of ``tapped`` (``launch.op_cost``
counts them): its kind, input, result and participants.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .sharding import mesh_shape

#: ops whose tensors gloo cannot take on the card
GLOO_HOST_OPS = frozenset({"send", "recv"})

#: tensors moved through host memory by ``via_host``, by op: the count
#: and the bytes
HOST_HOPS: dict[str, list] = {}

#: every collective's payload on this rank, by op: the count and the
#: bytes this rank puts in
TRAFFIC: dict[str, list] = {}


#: the taps of ``tapped``, innermost last
_TAPS: list = []


@contextlib.contextmanager
def tapped(tap):
    """Within: ``tap.begin()`` before and ``tap.end(kind, x, result, n)``
    after every collective this process runs (``kind`` one of
    ``core.ring.RING_KINDS``, ``x`` its input, ``result`` its output or
    None when it raised, ``n`` its participants)."""
    _TAPS.append(tap)
    try:
        yield tap
    finally:
        _TAPS.remove(tap)


def _run(kind: str, n: int, x: torch.Tensor, body):
    """``body()``, one collective of ``kind`` over ``n`` ranks on ``x``,
    with the taps told of it."""
    for tap in _TAPS:
        tap.begin()
    out = None
    try:
        out = body()
        return out
    finally:
        for tap in _TAPS:
            tap.end(kind, x, out, n)


def _traffic(op: str, t: torch.Tensor) -> None:
    rec = TRAFFIC.setdefault(op, [0, 0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def via_host(op: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host for an op the backend cannot run on the card's
    memory (``GLOO_HOST_OPS`` under gloo), counted in ``HOST_HOPS``;
    ``t`` itself otherwise."""
    if not (t.is_cuda and op in GLOO_HOST_OPS
            and dist.get_backend() == "gloo"):
        return t
    rec = HOST_HOPS.setdefault(op, [0, 0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()
    return t.cpu()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One rank's place on one mesh dim."""

    names: tuple[str, ...]
    size: int
    index: int
    group: object            # torch.distributed ProcessGroup
    ranks: tuple[int, ...]   # global ranks along the dim, by index

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``) over the dim, out of place."""
        if self.size == 1:
            return x
        return _run("all-reduce", self.size, x,
                    lambda: self._all_reduce(x, op))

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, by index."""
        if self.size == 1:
            return x
        return _run("all-gather", self.size, x,
                    lambda: self._all_gather(x, dim))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the dim of every rank's ``x``, this rank's block
        of it along ``dim``."""
        if self.size == 1:
            return x
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {self.names} ({self.size})")
        return _run("reduce-scatter", self.size, x,
                    lambda: self._reduce_scatter(x, dim))

    def _all_reduce(self, x, op):
        _traffic("all_reduce", x)
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return _released(y)

    def _all_gather(self, x, dim):
        _traffic("all_gather", x)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def _reduce_scatter(self, x, dim):
        _traffic("reduce_scatter", x)
        parts = [p.contiguous() for p in torch.chunk(x, self.size, dim)]
        out = torch.empty_like(parts[self.index])
        dist.reduce_scatter(out, parts, group=self.group)
        return _released(out)

    def gather(self, x: torch.Tensor, dim: int,
               grad: str = "sum") -> torch.Tensor:
        """``all_gather`` under autograd: the backward reduce-scatters
        the gradient (``grad="sum"``: each rank's consumer differs), or
        takes this rank's block of it (``grad="own"``: every rank
        holds the same whole gradient)."""
        if self.size == 1:
            return x
        return _Gather.apply(x, self, dim, grad)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the dim under autograd: identity backward."""
        if self.size == 1:
            return x
        return _Reduce.apply(x, self)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, the gradient summed over the dim backward."""
        if self.size == 1:
            return x
        return _Enter.apply(x, self)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``reduce_scatter`` under autograd: the backward all-gathers
        the gradient (each rank's block of the sum came from every
        rank's partial)."""
        if self.size == 1:
            return x
        return _Scatter.apply(x, self, dim)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {self.names} ({self.size})")
        step = n // self.size
        return x.narrow(dim, self.index * step, step)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """One hop of a ring: send ``x`` to the next rank along the dim
        and return what the previous one sent (the JAX package's
        ``ppermute`` with ``perm = [(i, i + 1 mod n)]``)."""
        if self.size == 1:
            return x
        return _run("collective-permute", self.size, x,
                    lambda: self._shift(x))

    def _shift(self, x):
        _traffic("send", x)
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        out = via_host("send", x.contiguous())
        buf = via_host("recv", torch.empty_like(x))
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, nxt, self.group),
            dist.P2POp(dist.irecv, buf, prv, self.group)])
        for r in reqs:
            r.wait()
        return buf.to(x.device)


def _released(t: torch.Tensor) -> torch.Tensor:
    """A collective's result as a tensor of its own over the same
    storage.  The backend's worker may hold ``t`` itself for a moment
    after the wait returns; the autograd engine adopts a gradient as a
    leaf's ``.grad`` only when nothing else holds it, and copies it
    otherwise — an op the step's dry trace does not have, run or not
    by timing.  Nothing holds the alias."""
    return t.detach()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, grad):
        if grad not in ("sum", "own"):
            raise ValueError(f"grad {grad!r}: 'sum' or 'own'")
        ctx.ax, ctx.dim, ctx.grad = ax, dim, grad
        return ax.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.ax, ctx.dim
        if ctx.grad == "sum":
            g = ax.reduce_scatter(g, dim)
        else:
            g = ax.shard(g, dim)
        return g, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return ax.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_gather(g, ctx.dim), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return ax.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_reduce(g), None


class DryAxis(Axis):
    """An ``Axis`` without a process group: each collective returns a
    tensor of its result's shape and type on its input's device (the
    input repeated, or its block) and moves nothing; the taps see it as
    they see a real one.  ``TRAFFIC`` and ``HOST_HOPS`` count real
    collectives only."""

    def _all_reduce(self, x, op):
        return x.clone()

    def _all_gather(self, x, dim):
        return torch.cat([x] * self.size, dim=dim)

    def _reduce_scatter(self, x, dim):
        return torch.chunk(x, self.size, dim)[self.index].clone(
            memory_format=torch.contiguous_format)

    def _shift(self, x):
        return x.clone()


class DryMesh:
    """A mesh stand-in that starts no world: ``shape`` {dim name: size},
    seen from ``rank`` (row-major over the dims), whose ``axis`` gives
    ``DryAxis``es — one rank's view of a mesh of any size, for tracing
    a step on the ``meta`` device."""

    def __init__(self, shape: dict, rank: int = 0):
        self.shape = dict(shape)
        self.rank = rank
        self.coordinate = dict(zip(self.shape, _unravel(
            rank, tuple(self.shape.values()))))

    def _rank_of(self, coord: dict) -> int:
        r = 0
        for name, size in self.shape.items():
            r = r * size + coord[name]
        return r

    def axis(self, names) -> Optional[DryAxis]:
        names = tuple(n for n in ((names,) if isinstance(names, str)
                                  else names) if self.shape[n] > 1)
        if not names:
            return None
        sizes = [self.shape[n] for n in names]
        ranks, index = [], 0
        for i, c in enumerate(itertools.product(*map(range, sizes))):
            coord = dict(self.coordinate, **dict(zip(names, c)))
            ranks.append(self._rank_of(coord))
            if ranks[-1] == self.rank:
                index = i
        return DryAxis(names, math.prod(sizes), index, None, tuple(ranks))


def _unravel(i: int, sizes: tuple) -> list[int]:
    out = []
    for size in reversed(sizes):
        out.append(i % size)
        i //= size
    return out[::-1]


def axis(mesh, names) -> Optional[Axis]:
    """This rank's ``Axis`` over the mesh dim(s) ``names`` (a name or a
    tuple of names), or None for no dim or dims of size 1.  Over several
    dims of size > 1 the axis is one process group over the ranks they
    span, indexed row-major in the order of ``names``; every rank makes
    it on first use (a collective call), once per mesh and names.  A
    ``DryMesh`` gives a ``DryAxis``."""
    if mesh is None or not names:
        return None
    if isinstance(mesh, DryMesh):
        return mesh.axis(names)
    shape = mesh_shape(mesh)
    names = tuple(n for n in ((names,) if isinstance(names, str) else names)
                  if shape[n] > 1)
    if not names:
        return None
    if len(names) == 1:
        group = mesh.get_group(names[0])
        return Axis(names, shape[names[0]], mesh.get_local_rank(names[0]),
                    group, tuple(dist.get_process_group_ranks(group)))
    made = mesh.__dict__.setdefault("_axes_over_dims", {})
    if names not in made:
        made[names] = _axis_over(mesh, names)
    return made[names]


def _axis_over(mesh, names: tuple[str, ...]) -> Axis:
    """The ``Axis`` over several dims of a DeviceMesh: the subgroups of
    ranks that differ only along ``names`` (all of them made by every
    rank, as ``torch.distributed`` requires), this rank's among them."""
    dims = list(mesh.mesh_dim_names)
    idx = [dims.index(n) for n in names]
    rest = [i for i in range(len(dims)) if i not in idx]
    size = math.prod(mesh.mesh.shape[i] for i in idx)
    groups = [row.tolist() for row in
              mesh.mesh.permute(*rest, *idx).reshape(-1, size)]
    group, _ = dist.new_subgroups_by_enumeration(groups)
    me = dist.get_rank()
    ranks = next(g for g in groups if me in g)
    return Axis(names, size, ranks.index(me), group, tuple(ranks))


def gather_dims(t: torch.Tensor, layout: Sequence, mesh,
                keep: tuple[str, ...] = (),
                summed: tuple[str, ...] = ()) -> torch.Tensor:
    """``t`` (a local shard laid out as ``layout``) gathered whole
    along every dim sharded over a mesh dim not in ``keep`` — the FSDP
    gather of a weight before its use.  Under autograd the gradient is
    reduce-scattered over the mesh dims in ``summed`` (those the batch
    is split on: each rank's consumer differs) and sliced over the
    others (``Axis.gather``)."""
    for d, entry in enumerate(layout):
        names = tuple(n for n in _names(entry) if n not in keep)
        for n in reversed(names):
            ax = axis(mesh, n)
            if ax is not None:
                t = ax.gather(t, d, "sum" if n in summed else "own")
    return t


def _names(entry) -> tuple[str, ...]:
    """The mesh dims of one layout entry (a name, a tuple, or None)."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def layout_dims(layout: Sequence) -> tuple[str, ...]:
    """The mesh dims a layout shards over, in order."""
    return tuple(n for entry in layout for n in _names(entry))


def shard_dims(t: torch.Tensor, layout: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` laid out as
    ``layout`` (dims over several mesh dims split row-major), copied
    out of ``t`` so that the whole may be freed (a block of leading
    rows is a view that would keep all of ``t`` alive)."""
    block = t
    for d, entry in enumerate(layout):
        for n in _names(entry):
            ax = axis(mesh, n)
            if ax is not None:
                block = ax.shard(block, d)
    return block if block is t else block.clone(
        memory_format=torch.contiguous_format)
