"""The port's SSD scan (``repro_torch.kernels.ssd_scan``, through ``ops``)
against the reference's Pallas kernel in interpret mode, its chunked form
``repro.models.ssm.ssd_chunked`` and the sequential oracle
``ssd_scan_ref``.

On the CPU the wrapper runs its plain version (the port's
``ssd_chunked``); the CUDA kernel runs only on the card
(``tests/test_torch_lm_cuda.py``). Inputs are made with numpy from a seed
and handed to both packages. Bars are those of ``tests/test_kernels.py``:
outputs divided by max |ref|, then f32 atol 2e-5 / rtol 1e-4, bf16 atol
6e-3 / rtol 3e-2; chunked against sequential atol 2e-4 / rtol 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models.ssm import ssd_chunked as jax_chunked
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import ssm


def _tol(dtype):
    return dict(atol=6e-3, rtol=3e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


SSD_CASES = [
    # (B, S, H, P, N, dtype, chunk) of tests/test_kernels.py
    (2, 256, 4, 64, 128, "float32", 128),
    (1, 512, 8, 64, 128, "bfloat16", 128),
    (2, 128, 2, 32, 64, "float32", 64),
    (1, 256, 1, 128, 32, "float32", 256),       # single chunk
]


def _inputs(B, S, H, P, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Adt = (-np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
           * 0.5).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx = (jnp.asarray(X, jd), jnp.asarray(Adt), jnp.asarray(Bc, jd),
          jnp.asarray(Cc, jd))
    tt = (torch.from_numpy(X).to(td), torch.from_numpy(Adt),
          torch.from_numpy(Bc).to(td), torch.from_numpy(Cc).to(td))
    return jx, tt


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("B,S,H,P,N,dtype,chunk", SSD_CASES)
def test_plain_matches_pallas_chunked_and_sequential(B, S, H, P, N, dtype,
                                                     chunk):
    jx, tt = _inputs(B, S, H, P, N, dtype)
    out = ops.ssd_scan(*tt, chunk=chunk)
    assert out.dtype == tt[0].dtype and out.shape == (B, S, H, P)
    seq, _ = jax_ssd_ref(*jx)
    scale = float(jnp.abs(seq.astype(jnp.float32)).max())
    for want in (pallas_ssd(*jx, chunk=chunk, interpret=True),
                 jax_chunked(*jx, chunk)[0], seq):
        np.testing.assert_allclose(_np(out) / scale, _np(want) / scale,
                                   **_tol(dtype))
    # the port's sequential oracle against the reference's
    np.testing.assert_allclose(_np(ssd_scan_ref(*tt)[0]) / scale,
                               _np(seq) / scale, **_tol(dtype))


def test_chunked_final_state_matches_reference():
    """The port's ``ssd_chunked`` (the plain version) returns the
    reference's final state as well as its Y."""
    jx, tt = _inputs(2, 256, 4, 64, 128, "float32", seed=3)
    y, s = ssm.ssd_chunked(*tt, 64)
    jy, js = (np.asarray(a) for a in jax_chunked(*jx, 64))
    ys, ss = ssm.ssd_reference(*tt)
    for got, want, seq in ((y.numpy(), jy, ys.numpy()),
                           (s.numpy(), js, ss.numpy())):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(got, seq, atol=2e-4, rtol=1e-3)


def test_plain_chunk_invariance():
    """Output must not depend on the chunking (a pure blocking choice)."""
    _, tt = _inputs(1, 256, 2, 64, 64, "float32", seed=1)
    a = ops.ssd_scan(*tt, chunk=64)
    b = ops.ssd_scan(*tt, chunk=256)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=1e-3)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    _, tt = _inputs(1, 96, 1, 16, 16, "float32")
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        ops.ssd_scan(*tt, chunk=64)


def test_cpu_calls_launch_nothing_and_the_kernel_raises():
    _, tt = _inputs(1, 64, 2, 16, 16, "float32")
    ssd.reset_launches()
    ops.ssd_scan(*tt, chunk=32)
    ops.ssd_scan(*tt, chunk=32, backend="torch")
    assert ssd.launches == {"ssd_scan": 0, "ssd_scan_backward": 0}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd.kernel_forward(*tt, chunk=32)
    with pytest.raises(ValueError, match="unknown backend 'triton'"):
        ops.ssd_scan(*tt, chunk=32, backend="triton")


@pytest.mark.parametrize("P,N,dtype,chunk,match", [
    (48, 64, "float32", 64, "built for P"),
    (64, 72, "float32", 64, "built for P"),
    (64, 128, "float16", 64, "float32 or bfloat16"),
    (128, 128, "float32", 16384, "shared memory"),
])
def test_kernel_inputs_are_checked(P, N, dtype, chunk, match):
    """What the kernel does not take raises before any launch."""
    X = torch.zeros((1, chunk, 2, P), dtype=getattr(torch, dtype))
    Bc = torch.zeros((1, chunk, N), dtype=X.dtype)
    with pytest.raises(ValueError, match=match):
        ssd._check(X, torch.zeros((1, chunk, 2)), Bc, Bc, chunk)


def test_smem_budget_fits_hopper():
    """The reference's ``vmem_bytes_ssd`` check, for the card: the largest
    block's shared memory at mamba2-130m (chunk 256, P 64, N 128) and at
    every P, N and chunk the model configs and tests build fits the 227 KB
    a block may use, for both dtypes."""
    assert ssd.smem_bytes(256, 64, 128) == 71_696
    assert ssd.smem_bytes(256, 64, 128, torch.float32) == 133_120
    for dtype in (torch.bfloat16, torch.float32):
        for P in ssd.HEAD_DIMS:
            for N in (16, 32, 64, 128):
                for chunk in (32, 64, 128, 256):
                    assert ssd.smem_bytes(chunk, P, N, dtype) \
                        <= _build.SMEM_PER_BLOCK


def test_scratch_bytes_at_mamba2_130m():
    """The bf16 kernel's float32 scratch at the mamba2-130m prefill (4,
    2048) tokens, chunk 256: (B, H, S / Q, P, N) chunk states and (B, H,
    S / Q) chunk decays, 25.2 MB."""
    assert ssd.scratch_bytes(4, 2048, 24, 256, 64, 128) == 25_168_896
    assert ssd.scratch_bytes(1, 256, 1, 256, 16, 16) == 4 * (16 * 16 + 1)


def test_bf16_rows_must_be_16_byte_aligned():
    """The bf16 kernel copies rows of X, Bc and Cc 16 bytes at a time: a
    view whose strides are not multiples of 8 elements raises."""
    X = torch.zeros((1, 64, 2, 16), dtype=torch.bfloat16)
    Adt = torch.zeros((1, 64, 2))
    Bc = torch.zeros((1, 64, 20), dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="16 bytes"):
        ssd._check(X, Adt, Bc, Bc, 64)
    ssd._check(X, Adt, Bc.contiguous(), Bc.contiguous(), 64)
