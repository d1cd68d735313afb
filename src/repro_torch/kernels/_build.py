"""Build a ``csrc/*.cu`` source into a shared library with ``nvcc``, load it
with ``ctypes``, and the dispatch every kernel wrapper shares.

The library is built at first use into ``<checkout>/build/kernels/``. Its
file name carries a hash of the source, the shared ``csrc/*.cuh`` headers
and the compiler flags, so a stale ``.so`` is never loaded: editing the
source or a header builds a new one. The build
writes to a temporary name and renames it into place, so a concurrent or
interrupted build never leaves a half-written library under the final
name. :func:`build_all` runs one ``nvcc`` per source, all at once.

Dispatch (``backend`` of every wrapper): ``"auto"`` launches the kernel for
CUDA tensors and runs the plain version for CPU tensors; ``"cuda"``
launches the kernel and raises for CPU tensors; ``"torch"`` runs the plain
version on the tensors' own device (how ``chip_smoke.py`` holds a kernel
against it). A failed launch raises; nothing falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, List

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# bytes of shared memory one block may use on Hopper (after opting in)
SMEM_PER_BLOCK = 232_448
# the dtype codes of the csrc entry points that take float32 or bfloat16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built; the
    hash covers the source, every ``csrc/*.cuh`` header and the flags."""
    src = b"".join(f.read_bytes() for f in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str]) -> List[pathlib.Path]:
    """Compile every ``csrc/<name>.cu`` whose hashed library is missing, one
    ``nvcc`` process per source, all started together."""
    names = list(names)
    outs = [library_path(n) for n in names]
    procs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    return build_all([name])[0]


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, cached per process;
    every entry point of ``signatures`` gets its ``argtypes`` and returns a
    C ``int`` (the launch's ``cudaError_t``)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def use_kernel(x: torch.Tensor, backend: str, module: str) -> bool:
    """Whether a wrapper of ``module`` given ``x`` launches its kernel (see
    the module docstring); raises for ``backend="cuda"`` on a CPU tensor."""
    if backend == "auto":
        return x.is_cuda
    if backend == "cuda":
        if not x.is_cuda:
            raise ValueError(f"backend='cuda' needs CUDA tensors; got a "
                             f"tensor on {x.device}")
        return True
    if backend == "torch":
        return False
    raise ValueError(f"unknown {module} backend {backend!r}")


def check_16_byte_rows(*named: tuple) -> None:
    """Raise unless each ``(name, tensor)`` starts on 16 bytes and its
    strides other than the last (of dimensions longer than 1) are multiples
    of 16 bytes: the bfloat16 kernels copy their rows into shared memory 16
    bytes at a time."""
    for name, t in named:
        step = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
                st % step for st, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(
                f"the bfloat16 kernel copies rows of {name} 16 bytes at a "
                f"time: it must start on 16 bytes with strides that are "
                f"multiples of {step} elements; got strides {t.stride()} "
                f"(.contiguous() gives such a tensor)")


def raise_on(rc: int, fn: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")
