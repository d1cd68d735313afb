"""Build a ``csrc/*.cu`` source into a shared library with ``nvcc``, load it
with ``ctypes``, and the dispatch every kernel wrapper shares.

The library is built at first use into ``<checkout>/build/kernels/``. Its
file name carries a hash of the source, the shared ``csrc/*.cuh`` headers
and the compiler flags, so a stale ``.so`` is never loaded: editing the
source or a header builds a new one. The build
writes to a temporary name and renames it into place, so a concurrent or
interrupted build never leaves a half-written library under the final
name. :func:`build_all` runs one ``nvcc`` per source, all at once.

Dispatch: :func:`route` alone decides which implementation runs, from the
tensors' device and ``backend`` (``"auto"`` or ``"torch"``, which every
wrapper, model and the optimizer pass down): the kernel on the card, the
CPU's own path off it, or the plain version wherever ``"torch"`` asks for
it (how ``chip_smoke.py`` holds a kernel against it). A kernel's entry
point raises for tensors off the card (:func:`check_cuda`), and a failed
launch raises; nothing falls back to the plain version.

Gradients (:func:`needs_grad`, :func:`check_no_grad`,
:func:`recompute_grads`): a kernel fills its output through a raw
pointer, so the LM wrappers route grad-requiring inputs through an
``autograd.Function`` whose backward recomputes from the saved inputs
(the reference's own function, or for flash attention its scores a
block at a time), and a kernel launched on such inputs outside it
raises.
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
from torch._subclasses.fake_tensor import is_fake

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


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's implementation: a CUDA tensor, or a
    fake one (``FakeTensorMode``, the dry-run's trace) on either device, so
    that a trace holds what the card runs."""
    return x.is_cuda or is_fake(x)


def route(x: torch.Tensor, backend: str) -> str:
    """Which implementation runs on ``x``; the one place that decides.

    - ``"kernel"`` (``backend="auto"``, :func:`on_card`): the registered op,
      whose CUDA implementation launches the kernel and whose fake one
      traces it as one node; the forest wrappers launch directly.
    - ``"reference"`` (``"auto"`` off the card): the models run the
      reference's own functions, autograd straight through them; a wrapper
      or the optimizer called directly calls its registered op, whose CPU
      implementation is the plain version; the forest wrappers run their
      plain versions.
    - ``"plain"`` (``"torch"``): the plain version on ``x``'s own device,
      no op.

    Any other ``backend`` raises ``ValueError``."""
    if backend == "torch":
        return "plain"
    if backend != "auto":
        raise ValueError(f"unknown backend {backend!r}: 'auto' or 'torch'")
    return "kernel" if on_card(x) else "reference"


def check_cuda(module: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` is a CUDA tensor: a kernel's entry point reads
    and writes device memory through raw pointers."""
    if not x.is_cuda:
        raise ValueError(f"the {module} kernel needs CUDA tensors; got a "
                         f"tensor on {x.device}")


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


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on ``tensors``: grad is enabled
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_no_grad(module: str, *tensors: torch.Tensor) -> None:
    """Raise if a kernel launch on ``tensors`` would cut the gradient: its
    output, filled through a raw pointer, would carry no ``grad_fn``."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"the {module} kernel writes its output through a raw pointer, "
            f"so launching it on inputs that require grad would cut every "
            f"gradient through it; call the {module} wrapper, which routes "
            f"them through its autograd.Function")


def recompute_grads(fn, saved, needs, grad_out) -> list:
    """The gradients of ``fn(*saved)`` with respect to the inputs marked in
    ``needs`` (None for the others), taken by autograd from ``fn``
    recomputed on detached copies of ``saved``: the backward of a kernel's
    ``autograd.Function``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = fn(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return [next(grads) if t.requires_grad else None for t in inputs]


def raise_on(rc: int, fn: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")
