"""The port's flash attention (``repro_torch.kernels.flash_attention``,
through ``ops``) against the reference's Pallas kernel, run in interpret
mode, and its oracle ``flash_attention_ref``.

On the CPU the wrapper runs its plain version; the CUDA kernel runs only
on the card (``tests/test_torch_lm_cuda.py``). Inputs are made with numpy
from a seed and handed to both packages. Bars are those of
``tests/test_kernels.py``: f32 atol 2e-5 / rtol 1e-4, bf16 atol 6e-3 /
rtol 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref


def _tol(dtype):
    return dict(atol=6e-3, rtol=3e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


ATTN_CASES = [
    # (B, S, H, KV, D, dtype, block_q, block_kv) of tests/test_kernels.py
    (2, 256, 4, 2, 64, "float32", 128, 128),
    (1, 512, 8, 8, 128, "bfloat16", 128, 256),
    (2, 128, 4, 1, 64, "bfloat16", 64, 128),    # MQA
    (1, 256, 2, 2, 128, "float32", 256, 64),    # bq > bkv
    (1, 128, 6, 6, 64, "float32", 128, 128),    # single block
    # ragged S (not a multiple of the CUDA kernel's 64-row tiles); the
    # Pallas kernel takes it as one block
    (2, 300, 4, 2, 32, "float32", 300, 300),
]


def _qkv(B, S, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return jx, tt


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("B,S,H,KV,D,dtype,bq,bkv", ATTN_CASES)
def test_plain_matches_pallas_and_oracle(B, S, H, KV, D, dtype, bq, bkv):
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, KV, D, dtype)
    out = ops.flash_attention(q, k, v)
    assert out.dtype == q.dtype and out.shape == (B, S, H, D)
    pallas = pallas_flash(jq, jk, jv, block_q=bq, block_kv=bkv,
                          interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jax_ref(jq, jk, jv)),
                               **_tol(dtype))
    # the port's own oracle is the plain version, bit for bit
    assert torch.equal(out, flash_attention_ref(q, k, v))


def test_plain_is_causal():
    """Perturbing future tokens cannot change earlier outputs."""
    _, (q, k, v) = _qkv(1, 256, 2, 2, 64, "float32", seed=1)
    base = ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = 9.0
    v2[:, 128:] = -9.0
    pert = ops.flash_attention(q, k2, v2)
    np.testing.assert_allclose(base[:, :128].numpy(), pert[:, :128].numpy(),
                               atol=1e-6, rtol=1e-6)


def test_cpu_calls_launch_nothing_and_cuda_backend_raises():
    _, (q, k, v) = _qkv(1, 64, 2, 1, 16, "float32")
    fa.reset_launches()
    ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v, backend="torch")
    assert fa.launches == {"flash_attention": 0}
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA"):
        ops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="unknown flash_attention backend"):
        ops.flash_attention(q, k, v, backend="xla")


@pytest.mark.parametrize("shapes,dtype,match", [
    (((1, 64, 4, 16), (1, 64, 3, 16)), torch.float32, "H % KV"),
    (((1, 64, 4, 48), (1, 64, 2, 48)), torch.float32, "head dims"),
    (((1, 64, 4, 16), (1, 64, 2, 16)), torch.float16, "float32 or bfloat16"),
    (((1, 64, 4, 16), (1, 32, 2, 16)), torch.float32, "do not fit"),
])
def test_kernel_inputs_are_checked(shapes, dtype, match):
    """What the kernel does not take raises before any launch."""
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa._check(q, k, k)


def test_smem_budgets_fit_hopper():
    """The shared memory of one block fits the 227 KB a block may use on
    Hopper at every head dim and dtype the kernel is built for (the
    reference's ``vmem_bytes_attention`` check, for the card)."""
    for dtype in (torch.bfloat16, torch.float32):
        for d in fa.HEAD_DIMS:
            assert fa.smem_bytes(d, dtype) <= _build.SMEM_PER_BLOCK
    # llama3.2-1b: D = 64, three blocks of 128 threads fit on one SM
    assert 3 * fa.smem_bytes(64) <= 228 * 1024
    # bf16: the q tile and two stages of k and v tiles, rows of 64 + 8
    assert fa.smem_bytes(64) == 46_080
    assert fa.smem_bytes(64, torch.float32) == 67_584


def test_bf16_rows_must_be_16_byte_aligned():
    """The bf16 kernel copies rows 16 bytes at a time: a view whose strides
    are not multiples of 8 elements raises before any launch (float32,
    which the CUDA-core kernel reads element by element, does not)."""
    k = torch.zeros((1, 64, 2, 16))
    fa._check(torch.zeros((1, 64, 4, 17))[..., :16], k, k)
    q = torch.zeros((1, 64, 4, 17), dtype=torch.bfloat16)[..., :16]
    k = k.bfloat16()
    with pytest.raises(ValueError, match="16 bytes"):
        fa._check(q, k, k)
    fa._check(q.contiguous(), k, k)
