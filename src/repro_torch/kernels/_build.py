"""Build the CUDA kernels from ``csrc/`` and load them with ctypes.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by the
hash of its source and of every header of ``csrc/`` it includes, so an
edit to either rebuilds and an unchanged source is loaded as it is.
The libraries go to ``kernels/build/`` (listed in ``.gitignore``);
nothing is built until a kernel is first launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel library cannot be built: no ``nvcc``, or ``nvcc``
    rejected the source.  No reliability guard degrades from it
    (``reliability.breaker.degradable``): a card without a working
    toolchain must fail loudly, not serve the twins."""


class KernelLaunchError(RuntimeError):
    """A kernel's launcher returned a CUDA error: ``code`` is the
    ``cudaError_t``, the message its ``cudaGetErrorString`` text.  A
    guard degrades only from a launch the card refused without running
    it (``reliability.breaker.degradable``)."""

    def __init__(self, entry: str, code: int, text: str):
        super().__init__(f"{entry} failed: {text}")
        self.code = code


def check_launch(lib: ctypes.CDLL, entry: str, err: int,
                 errors: str) -> None:
    """Raise a ``KernelLaunchError`` if the launcher ``entry`` returned
    the CUDA error ``err`` (0 is success); ``errors`` names the
    library's ``cudaGetErrorString`` export."""
    if err:
        fn = getattr(lib, errors)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise KernelLaunchError(entry, err, fn(err).decode())


def _nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (default: the toolkit's
    conventional prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    ``#include "..."``, directly or through another such file."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in out:
            out.append(path)
            todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return out


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns
    (library path, the compiler's ``-Xptxas -v`` report or "")."""
    out = library_path(name)
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
             str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed on {name}.cu:\n"
                                   f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _ = build(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path.name}: {e}") from e
        _LIBS[name] = lib
    return lib
