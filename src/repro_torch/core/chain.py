"""MBCI operator-chain IR (paper §III-A).

A Chain is a small dataflow program over named cross-tile loops:
compute-intensive ops (matmul-class blocks) read/write tensors whose
dims are loop names.  This is the input to search-space generation.

The paper's two evaluated chain families are provided as constructors:
  * gemm_chain:      C = A@B ; E = C@D          (Table II, G1..G12)
  * attention_chain: S = Q@K^T ; P = softmax(S) ; O = P@V   (Table III, S1..S9)

Epilogues (softmax & friends) are *attached* to compute ops rather than
modeled as separate cross-tile ops — matching the paper: "we apply
standard fusion optimizations for memory-intensive operators in line
with previous work" (§III-A).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


@dataclass(frozen=True)
class TensorSpec:
    """A tensor whose axes are cross-tile loop names."""

    name: str
    dims: tuple[str, ...]
    dtype: str = "float32"

    @property
    def dtype_bytes(self) -> int:
        return DTYPE_BYTES[self.dtype]


@dataclass(frozen=True)
class OpSpec:
    """One compute-intensive block: out[spatial] (+)= reduce over `reduce_dims`.

    epilogue: name of a fused memory-intensive tail applied to `out`
    ("online_softmax" for attention scores; None otherwise).  An
    online_softmax epilogue makes the *consumer's* accumulation over
    this op's reduce-adjacent spatial dim non-linear: schedules that
    interleave partial updates need rescaling support (FlashAttention
    semantics) and schedules that cannot express it are invalid.
    """

    name: str
    out: str
    ins: tuple[str, ...]
    reduce_dims: tuple[str, ...]
    epilogue: Optional[str] = None
    flops_per_point: int = 2  # MAC = 2 flops


@dataclass(frozen=True)
class Chain:
    """An MBCI operator chain over shared cross-tile loops."""

    name: str
    loops: dict[str, int]  # loop name -> extent (problem dim size)
    tensors: dict[str, TensorSpec]
    ops: tuple[OpSpec, ...]
    batch: int = 1  # leading batch (mapped to extra grid axis, untiled)

    def signature(self) -> tuple:
        """Hashable content identity (Chain holds dicts, so the
        dataclass itself is unhashable).  Everything search-space
        generation reads is included; used to memoize per-chain
        candidate matrices (``pruning.generate_candidates_batch``)."""
        return (self.name, tuple(self.loops.items()),
                tuple((t.name, t.dims, t.dtype)
                      for t in self.tensors.values()),
                tuple((o.name, o.out, o.ins, o.reduce_dims, o.epilogue,
                       o.flops_per_point) for o in self.ops),
                self.batch)

    # ---- derived sets -------------------------------------------------
    def producers(self) -> dict[str, OpSpec]:
        return {op.out: op for op in self.ops}

    @property
    def input_names(self) -> tuple[str, ...]:
        prod = {op.out for op in self.ops}
        seen: list[str] = []
        for op in self.ops:
            for t in op.ins:
                if t not in prod and t not in seen:
                    seen.append(t)
        return tuple(seen)

    @property
    def output_names(self) -> tuple[str, ...]:
        consumed = {t for op in self.ops for t in op.ins}
        return tuple(op.out for op in self.ops if op.out not in consumed)

    @property
    def intermediate_names(self) -> tuple[str, ...]:
        consumed = {t for op in self.ops for t in op.ins}
        return tuple(op.out for op in self.ops if op.out in consumed)

    @property
    def spatial_loops(self) -> tuple[str, ...]:
        """Loops indexing a chain output — grid-bindable (paper Rule 1)."""
        out_dims: list[str] = []
        for name in self.output_names:
            for d in self.tensors[name].dims:
                if d not in out_dims:
                    out_dims.append(d)
        return tuple(out_dims)

    @property
    def reduction_loops(self) -> tuple[str, ...]:
        return tuple(l for l in self.loops if l not in self.spatial_loops)

    def op_related_loops(self, op: OpSpec) -> tuple[str, ...]:
        """Loops an op's compute depends on: its output dims + reductions."""
        rel = list(self.tensors[op.out].dims) + list(op.reduce_dims)
        return tuple(dict.fromkeys(rel))

    def exclusive_loops(self, op: OpSpec) -> tuple[str, ...]:
        """Loops related to exactly this op (used for flat tilings)."""
        mine = set(self.op_related_loops(op))
        for other in self.ops:
            if other.name != op.name:
                mine -= set(self.op_related_loops(other))
        return tuple(l for l in self.op_related_loops(op) if l in mine)

    def total_flops(self) -> int:
        total = 0
        for op in self.ops:
            pts = math.prod(self.loops[l] for l in self.op_related_loops(op))
            total += op.flops_per_point * pts
        return total * self.batch

    def io_bytes(self) -> int:
        """Unfused minimal HBM traffic: every tensor (incl. intermediates)
        crosses HBM once per producing/consuming kernel."""
        b = 0
        for t in self.tensors.values():
            size = math.prod(self.loops[d] for d in t.dims) * t.dtype_bytes
            mult = 1
            if t.name in self.intermediate_names:
                mult = 2  # written by producer kernel + read by consumer
            b += size * mult
        return b * self.batch

    def fused_io_bytes(self) -> int:
        """Ideal fused HBM traffic: inputs read once, outputs written once."""
        b = 0
        for name in self.input_names + self.output_names:
            t = self.tensors[name]
            b += math.prod(self.loops[d] for d in t.dims) * t.dtype_bytes
        return b * self.batch

    def arithmetic_intensity(self) -> float:
        return self.total_flops() / max(1, self.io_bytes())


# ---------------------------------------------------------------------------
# Constructors for the paper's workloads
# ---------------------------------------------------------------------------

def gemm_chain(M: int, N: int, K: int, H: int, batch: int = 1,
               dtype: str = "float32", name: str = "gemm_chain") -> Chain:
    """C[m,n] = A[m,k] @ B[k,n] ;  E[m,h] = C[m,n] @ D[n,h]  (paper Fig. 3)."""
    loops = {"m": M, "n": N, "k": K, "h": H}
    tensors = {
        "A": TensorSpec("A", ("m", "k"), dtype),
        "B": TensorSpec("B", ("k", "n"), dtype),
        "C": TensorSpec("C", ("m", "n"), dtype),
        "D": TensorSpec("D", ("n", "h"), dtype),
        "E": TensorSpec("E", ("m", "h"), dtype),
    }
    ops = (
        OpSpec("matmul_C", "C", ("A", "B"), ("k",)),
        OpSpec("matmul_E", "E", ("C", "D"), ("n",)),
    )
    return Chain(name, loops, tensors, ops, batch=batch)


def attention_chain(M: int, N: int, K: int, H: int, heads: int = 1,
                    batch: int = 1, dtype: str = "float32",
                    causal: bool = False, window: int = 0,
                    name: str = "attention") -> Chain:
    """S[m,n] = Q[m,k] @ K[k,n] ; P = softmax_n(S) ; O[m,h] = P[m,n] @ V[n,h].

    Same loop structure as the GEMM chain with an online-softmax epilogue
    on the first op (paper Table III uses identical M,N,K,H naming).
    `heads*batch` fold into the batch grid axis.
    """
    loops = {"m": M, "n": N, "k": K, "h": H}
    tensors = {
        "Q": TensorSpec("Q", ("m", "k"), dtype),
        "Kt": TensorSpec("Kt", ("k", "n"), dtype),
        "S": TensorSpec("S", ("m", "n"), dtype),
        "V": TensorSpec("V", ("n", "h"), dtype),
        "O": TensorSpec("O", ("m", "h"), dtype),
    }
    ops = (
        OpSpec("qk", "S", ("Q", "Kt"), ("k",), epilogue="online_softmax"),
        OpSpec("pv", "O", ("S", "V"), ("n",)),
    )
    return Chain(name, loops, tensors, ops, batch=batch * heads)


def mlp_chain(M: int, FF: int, D: int, batch: int = 1,
              dtype: str = "float32", gated: bool = True,
              act: str = "silu", name: str = "mlp_chain") -> Chain:
    """Transformer MLP as a 2-GEMM chain with a gated-activation epilogue:

        Hh[m,n] = act(A[m,k] @ Wg[k,n]) * (A[m,k] @ Wu[k,n])   (gated)
        Hh[m,n] = act(A[m,k] @ Wu[k,n])                        (ungated)
        E[m,h]  = Hh[m,n] @ Wd[n,h]

    Loop naming follows ``gemm_chain`` (m = tokens, n = d_ff, k = h =
    d_model) so the whole tiling/pruning/search stack applies
    unchanged.  The gated variant reads one extra input (Wg) and pays
    4 flops per reduction point (two MACs); the activation itself is a
    memory-intensive epilogue attached to the up-projection, exactly
    like online_softmax on the attention chain — it never becomes a
    cross-tile op.  This is the chain ``core.planner`` carves for the
    MLP half of a transformer block.
    """
    loops = {"m": M, "n": FF, "k": D, "h": D}
    tensors = {
        "A": TensorSpec("A", ("m", "k"), dtype),
        "Wu": TensorSpec("Wu", ("k", "n"), dtype),
        "Hh": TensorSpec("Hh", ("m", "n"), dtype),
        "Wd": TensorSpec("Wd", ("n", "h"), dtype),
        "E": TensorSpec("E", ("m", "h"), dtype),
    }
    ins: tuple[str, ...] = ("A", "Wu")
    if gated:
        tensors["Wg"] = TensorSpec("Wg", ("k", "n"), dtype)
        ins = ("A", "Wu", "Wg")
    ops = (
        OpSpec("mlp_up", "Hh", ins, ("k",),
               epilogue=(f"gated_{act}" if gated else act),
               flops_per_point=4 if gated else 2),
        OpSpec("mlp_down", "E", ("Hh", "Wd"), ("n",)),
    )
    return Chain(name, loops, tensors, ops, batch=batch)


def single_gemm(M: int, N: int, K: int, batch: int = 1,
                dtype: str = "float32", name: str = "gemm") -> Chain:
    """One GEMM C[m,n] = A[m,k] @ B[k,n] — the unfused-baseline unit:
    modeling unfused chains as a sequence of these keeps the hardware
    assumptions identical on both sides of every speedup we report."""
    loops = {"m": M, "n": N, "k": K}
    tensors = {
        "A": TensorSpec("A", ("m", "k"), dtype),
        "B": TensorSpec("B", ("k", "n"), dtype),
        "C": TensorSpec("C", ("m", "n"), dtype),
    }
    ops = (OpSpec("matmul", "C", ("A", "B"), ("k",)),)
    return Chain(name, loops, tensors, ops, batch=batch)


def gemm_chain3(M: int, N: int, K: int, H: int, G: int, batch: int = 1,
                dtype: str = "float32") -> Chain:
    """Three-GEMM chain — demonstrates >2-op generality (§III-A:
    'our analysis method naturally extends')."""
    loops = {"m": M, "n": N, "k": K, "h": H, "g": G}
    tensors = {
        "A": TensorSpec("A", ("m", "k"), dtype),
        "B": TensorSpec("B", ("k", "n"), dtype),
        "C": TensorSpec("C", ("m", "n"), dtype),
        "D": TensorSpec("D", ("n", "h"), dtype),
        "E": TensorSpec("E", ("m", "h"), dtype),
        "F": TensorSpec("F", ("h", "g"), dtype),
        "Gm": TensorSpec("Gm", ("m", "g"), dtype),
    }
    ops = (
        OpSpec("matmul_C", "C", ("A", "B"), ("k",)),
        OpSpec("matmul_E", "E", ("C", "D"), ("n",)),
        OpSpec("matmul_G", "Gm", ("E", "F"), ("h",)),
    )
    return Chain("gemm_chain3", loops, tensors, ops, batch=batch)
