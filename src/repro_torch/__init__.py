"""``repro_torch`` — the PROFET latency predictor on PyTorch and CUDA.

A port of ``repro`` (the JAX package, kept beside it as the reference)
that imports neither JAX nor ``repro``. Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``; asking
for CUDA on a host without it raises instead of carrying on on the CPU.

Float32 matrix products run in full IEEE float32, never TF32: the
reference runs its DNN member at ``jax_default_matmul_precision=
"highest"`` and the DNN parity bar is rtol 1e-5.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# torch's CPU elementwise math (exp, log, ...) runs through MKL's vector
# math library, which sets itself up at its first call in a process. When
# that first call comes from several OpenMP threads at once (a tensor above
# torch's parallel grain), one thread's chunk can, in a few processes, come
# back at a lower accuracy, enough to break the float32 parity of the plain
# SSD scan. One call here, on one thread, sets the library up before any
# parallel call can race it.
torch.exp(torch.zeros(1))


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
