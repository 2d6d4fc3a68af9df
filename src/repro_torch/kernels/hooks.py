"""The stitching hooks of the fused kernels: tile-local elementwise
expressions that run inside a kernel (FusionStitching, ``docs/planner.md``
§3).

The JAX package's kernels take any tile-local callable as ``prologue``
(on the A tile at load), ``epilogue`` (on the finished f32 output tile
before the store), ``q_prologue`` / ``k_prologue`` and ``o_epilogue``
(attention).  A CUDA kernel cannot run a Python callable, so the port's
kernels take an ``Elementwise``: a chain of at most ``MAX_STEPS`` steps
from a closed vocabulary, which the kernels interpret step by step
(``csrc/hook.cuh``)::

    Elementwise.of(("mul", 0.5), "tanh")      # tanh(0.5 x)

Each ``Elementwise`` has three views: ``__call__`` (the torch version,
which the plain versions and every CPU path run), ``key()`` (hashable,
for the launch counts of hooked variants and for tests) and ``as_c()``
(the struct every kernel entry takes by value).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F

MAX_STEPS = 8
# op codes of csrc/hook.cuh; the first four take a constant
OPS = {"mul": 0, "add": 1, "max": 2, "min": 3, "tanh": 4, "sigmoid": 5,
       "exp": 6, "square": 7, "relu": 8, "silu": 9, "gelu": 10}
WITH_CONSTANT = ("mul", "add", "max", "min")

_TORCH = {
    "mul": lambda x, c: x * c,
    "add": lambda x, c: x + c,
    "max": lambda x, c: torch.clamp(x, min=c),
    "min": lambda x, c: torch.clamp(x, max=c),
    "tanh": lambda x, c: torch.tanh(x),
    "sigmoid": lambda x, c: torch.sigmoid(x),
    "exp": lambda x, c: torch.exp(x),
    "square": lambda x, c: x * x,
    "relu": lambda x, c: F.relu(x),
    "silu": lambda x, c: F.silu(x),
    # the tanh form, as jax.nn.gelu defaults and the MLP kernel computes
    "gelu": lambda x, c: F.gelu(x, approximate="tanh"),
}

VOCABULARY = (", ".join(f"({op!r}, c)" for op in WITH_CONSTANT) + ", "
              + ", ".join(repr(op) for op in OPS if op not in WITH_CONSTANT))


class HookStruct(ctypes.Structure):
    """``struct Hook {int n; int op[8]; float c[8];}`` of csrc/hook.cuh."""
    _fields_ = [("n", ctypes.c_int), ("op", ctypes.c_int * MAX_STEPS),
                ("c", ctypes.c_float * MAX_STEPS)]


@dataclass(frozen=True)
class Elementwise:
    """A tile-local elementwise expression: ``steps`` applied in order,
    each (op, constant) with the constant 0.0 for an op that takes none.
    Frozen and hashable."""

    steps: tuple[tuple[str, float], ...] = ()

    def __post_init__(self):
        if len(self.steps) > MAX_STEPS:
            raise ValueError(f"an Elementwise holds at most {MAX_STEPS} "
                             f"steps, got {len(self.steps)}")
        for step in self.steps:
            if (not isinstance(step, tuple) or len(step) != 2
                    or step[0] not in OPS):
                raise ValueError(f"unknown step {step!r}; the vocabulary "
                                 f"is {VOCABULARY}")

    @classmethod
    def of(cls, *steps: Union[str, tuple]) -> "Elementwise":
        """``Elementwise.of(("mul", 0.5), "tanh")``: a bare name for an op
        without a constant, (name, constant) for one with."""
        out = []
        for step in steps:
            op, c = (step, None) if isinstance(step, str) else step
            if op not in OPS:
                raise ValueError(f"unknown op {op!r}; the vocabulary is "
                                 f"{VOCABULARY}")
            if (c is None) == (op in WITH_CONSTANT):
                raise ValueError(f"op {op!r} takes "
                                 + ("a constant" if op in WITH_CONSTANT
                                    else "no constant"))
            # the constant as the kernel holds it: an f32
            out.append((op, ctypes.c_float(c or 0.0).value))
        return cls(tuple(out))

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """The torch version: every step in f32, rounded once to t's
        type."""
        x = t.float()
        for op, c in self.steps:
            x = _TORCH[op](x, c)
        return x.to(t.dtype)

    def key(self) -> tuple:
        return tuple((op, c) if op in WITH_CONSTANT else (op,)
                     for op, c in self.steps)

    def as_c(self) -> HookStruct:
        s = HookStruct()
        s.n = len(self.steps)
        for i, (op, c) in enumerate(self.steps):
            s.op[i], s.c[i] = OPS[op], c
        return s

    def __bool__(self) -> bool:
        return bool(self.steps)


def check(hook, name: str = "hook") -> Optional[Elementwise]:
    """``hook`` as the kernels take it: None, or an ``Elementwise``
    (empty counts as None).  Anything else, a Python callable above all,
    raises ``TypeError`` on every device: a CUDA kernel runs only the
    closed vocabulary."""
    if hook is None or isinstance(hook, Elementwise):
        return hook or None
    what = "a Python callable" if callable(hook) else type(hook).__name__
    raise TypeError(f"{name} must be an Elementwise (repro_torch.kernels."
                    f"hooks), not {what}: the CUDA kernels run only the "
                    f"closed vocabulary {VOCABULARY}, at most {MAX_STEPS} "
                    f"steps")


def as_c(hook: Optional[Elementwise]) -> HookStruct:
    """The struct of ``hook``; no steps for None."""
    return HookStruct() if hook is None else hook.as_c()


def apply(hook: Optional[Elementwise], t: torch.Tensor) -> torch.Tensor:
    return t if hook is None else hook(t)


def note(wrapper, *hooks: Optional[Elementwise]) -> None:
    """Count one hooked launch of ``wrapper`` under its hooks' keys
    (``wrapper.hooked``); a launch without a hook is not counted here."""
    if any(h is not None for h in hooks):
        key = tuple(None if h is None else h.key() for h in hooks)
        wrapper.hooked[key] = wrapper.hooked.get(key, 0) + 1
