"""One step's cost, counted over the aten ops it runs — the port's
counterpart of the JAX package's ``launch/hlo_cost.py``.

The JAX package parses the optimized HLO of a compiled step and walks
its computations, multiplying ``while`` bodies by their trip counts.
Eager PyTorch has no program to parse and no ``while`` body: a Python
loop runs every pass, so ``OpCost`` — a ``TorchDispatchMode`` — sees
each op once per pass, on any device (the ``meta`` device included,
where nothing is computed).

Counting rules, per op (the granularity is one aten op, where the JAX
package's is one XLA fusion: the port runs eagerly, op by op):

  flops: the matmul class (``mm``, ``addmm``, ``bmm``, ``baddbmm``) by
         ``torch.utils.flop_counter``'s registry (2 M N K); an op tagged
         pointwise, its output elements; a reduction (tagged so, or a
         softmax), its input elements; data movement, none.
  bytes: every tensor argument plus every tensor output — views,
         reshapes, ``expand``, slicing and empty allocations are free
         (the counterpart of ``_FREE_OPS``); an in-place op's target
         counts once, as written; an in-place write through an index
         (``index_put_``, ``scatter_``, ...) costs what it writes, the
         slice, not the buffer.
  collectives: each one the process runs through ``dist.collectives``
         (real or dry), by kind, result bytes and participants, priced
         by ``core.ring.ring_traffic_bytes`` as the JAX package's
         ``hlo_analysis.parse_collectives`` does; its input and result
         count as bytes; the ops inside it count for nothing.

``attn`` holds what runs inside ``layers.attention_interior`` (the
streaming twin's interior: the counterpart of ``AttributedCost``), and
``rest`` the others.  ``peak`` is the high-water mark of the live bytes
of the storages the step creates plus those of its arguments
(``hold``): each non-aliasing output's storage is counted once, until
it is freed — the counterpart of ``memory_analysis()``.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core.ring import ring_traffic_bytes
from ..dist import collectives
from ..models import layers

aten = torch.ops.aten

MATMUL = frozenset({aten.mm, aten.addmm, aten.bmm, aten.baddbmm})
_FREE = frozenset({aten.empty, aten.empty_like, aten.empty_strided,
                   aten.new_empty, aten.new_empty_strided, aten.detach,
                   aten.alias, aten.lift_fresh, aten.resize_})
_SOFTMAX = frozenset({aten._softmax, aten._log_softmax, aten.logsumexp,
                      aten._softmax_backward_data,
                      aten._log_softmax_backward_data})
_INDEX_WRITES = frozenset({aten.index_put_, aten._index_put_impl_,
                           aten.index_copy_, aten.index_add_,
                           aten.scatter_, aten.scatter_add_,
                           aten.scatter_reduce_, aten.masked_scatter_})


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    mm_flops: float = 0.0     # the matmul class's part of ``flops``

    def add(self, other: "Cost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        self.mm_flops += other.mm_flops


@dataclasses.dataclass
class CollectiveStats:
    """The collectives of a step: ``records`` (kind, result bytes,
    participants) in the order they ran, and by kind their counts,
    result bytes and the per-rank link traffic of them all."""

    records: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)
    result_bytes: dict = dataclasses.field(default_factory=dict)
    traffic_bytes: float = 0.0

    def note(self, kind: str, result_bytes: int, n: int) -> None:
        self.records.append((kind, result_bytes, n))
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.result_bytes[kind] = self.result_bytes.get(kind, 0) \
            + result_bytes
        self.traffic_bytes += ring_traffic_bytes(kind, result_bytes, n)

    def as_dict(self) -> dict:
        return {"counts": self.counts, "result_bytes": self.result_bytes,
                "traffic_bytes": self.traffic_bytes}


class OpCost(TorchDispatchMode):
    """Within ``with``: every aten op this thread dispatches (and the
    autograd engine's, whose threads inherit the mode), and every
    collective, counted as the module doc says."""

    def __init__(self):
        super().__init__()
        self.attn, self.rest = Cost(), Cost()
        self.collectives = CollectiveStats()
        self.n_ops = 0
        self.held = 0            # the arguments' bytes (``hold``)
        self.live = 0            # the step's storages alive now
        self.peak = 0            # high-water of held + live
        self._keys: set = set()
        self._depth = 0          # collectives running
        self._tap = None

    @property
    def total(self) -> Cost:
        c = Cost()
        c.add(self.attn)
        c.add(self.rest)
        return c

    def hold(self, *trees) -> int:
        """Count the storages of ``trees``' tensors (the step's
        arguments, alive throughout) in the peak, each once; returns
        the bytes newly held."""
        new = 0
        for t in _tensors(trees):
            st = t.untyped_storage()
            if st._cdata not in self._keys:
                self._keys.add(st._cdata)
                new += st.nbytes()
        self.held += new
        self.peak = max(self.peak, self.held + self.live)
        return new

    def held_bytes(self, *trees) -> int:
        """The bytes of the held storages ``trees``' tensors use (the
        outputs that alias the arguments)."""
        keys, n = set(), 0
        for t in _tensors(trees):
            st = t.untyped_storage()
            if st._cdata in self._keys and st._cdata not in keys:
                keys.add(st._cdata)
                n += st.nbytes()
        return n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._keys:
            return
        n = st.nbytes()
        self._keys.add(key)
        self.live += n
        self.peak = max(self.peak, self.held + self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._keys.discard(key)
        self.live -= n

    def _region(self) -> Cost:
        return self.attn if layers.in_attention_interior() else self.rest

    # the collectives' tap (dist.collectives.tapped)
    def begin(self) -> None:
        self._depth += 1

    def end(self, kind: str, x: torch.Tensor, out, n: int) -> None:
        self._depth -= 1
        if out is None:
            return
        self.collectives.note(kind, nbytes(out), n)
        self._region().bytes += nbytes(x) + nbytes(out)
        self._track(out)

    def __enter__(self):
        self._tap = collectives.tapped(self)
        self._tap.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._tap.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        self.n_ops += 1
        self._count(func, args, kwargs, out)
        for ret, val in zip(func._schema.returns,
                            out if isinstance(out, tuple) else (out,)):
            if ret.alias_info is None:
                for t in _tensors(val):
                    self._track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return
        c = self._region()
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            if packet in MATMUL:
                c.mm_flops += f
        elif torch.Tag.reduction in func.tags or packet in _SOFTMAX:
            c.flops += ins[0].numel() if ins else 0
        elif torch.Tag.pointwise in func.tags:
            c.flops += sum(t.numel() for t in outs)
        if packet in _INDEX_WRITES:
            # the written values, read and written; the indices read
            c.bytes += sum(nbytes(t) for t in ins[1:]) + nbytes(ins[-1])
        elif func._schema.is_mutable:
            # the target counts once, as the output written
            c.bytes += sum(nbytes(t) for t in ins[1:]) \
                + sum(nbytes(t) for t in outs)
        else:
            c.bytes += sum(nbytes(t) for t in ins) \
                + sum(nbytes(t) for t in outs)
