"""The port's int8 error-feedback compression
(``repro_torch.distributed.compression``) against the reference's
(``repro.distributed.compression``): quantize, error feedback and
dequantize bit for bit in float32 over seeds and shapes (both round half
to even), the residual's bound (the twin of ``tests/test_properties.py``'s
EF test), and ``compressed_psum`` over 4 ``gloo`` ranks bit for bit
against the reference's on 4 forced host devices, each in a subprocess.

The reference runs there as ``jax.shard_map`` over a ``("pod",)`` mesh
under ``jax.set_mesh``, its per-pod slice reshaped rather than indexed:
``tests/test_properties.py``'s own script fails under jax 0.9.0 at its
``g[0]`` indexing of an explicitly sharded array, not in
``compression.py``."""
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.distributed import compression as C

from _torch_state import one_torch_thread  # noqa: F401

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent

SHAPES = [(64,), (3, 50), (7, 11, 13), (1,)]


def _case(seed, shape, scale):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    r = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
    return g, r


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 3e3),
                                        (3, 1e-30)])
def test_quantize_ef_dequantize_bit_for_bit(seed, shape, scale):
    g, r = _case(seed, shape, scale)
    jq, js = JC.quantize_int8(jnp.asarray(g))
    q, s = C.quantize_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(C.dequantize(q, s).numpy(),
                                  np.asarray(JC.dequantize(jq, js)))
    jq, js, jr = JC.ef_quantize(jnp.asarray(g), jnp.asarray(r))
    q, s, nr = C.ef_quantize(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jr))
    assert C.compression_error(torch.from_numpy(g)) == pytest.approx(
        JC.compression_error(jnp.asarray(g)), rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed,grow", [(0, 1.0), (1, 3.0), (2, 1e3)])
def test_quantize_with_a_given_absmax_bit_for_bit(seed, shape, grow):
    """``quantize_int8(x, absmax)`` (``compressed_psum``'s group scale)
    equals the reference's quantization of ``x`` next to one element of
    that magnitude, which sets the same scale."""
    g, _ = _case(seed, shape, 1.0)
    a = np.float32(np.abs(g).max() * grow)
    jq, js = JC.quantize_int8(jnp.asarray(np.append(g.ravel(), a)))
    q, s = C.quantize_int8(torch.from_numpy(g), torch.tensor(a))
    np.testing.assert_array_equal(q.numpy().ravel(), np.asarray(jq)[:-1])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_round_half_to_even_at_the_ties():
    """Values that land exactly on .5 steps round to the even integer in
    both packages."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 62.5, -63.5],
                 np.float32)
    q, _ = C.quantize_int8(torch.from_numpy(x))
    jq, _ = JC.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 62, -64]


@pytest.mark.parametrize("seed", range(5))
def test_ef_residual_stays_bounded(seed):
    """Error feedback must not accumulate: the residual stays within one
    quantization step of zero under a constant gradient."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(32)
                         .astype(np.float32))
    r = torch.zeros_like(g)
    for _ in range(30):
        q, s, r = C.ef_quantize(g, r)
    assert float(r.abs().max()) <= float(s) + 1e-6


def test_init_residuals_are_float32_zeros_per_leaf():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2, 2)}}
    r = C.init_residuals(tree)
    assert r["a"].dtype == torch.float32 and r["a"].shape == (3,)
    assert r["b"]["c"].shape == (2, 2) and float(r["b"]["c"].abs().sum()) == 0


_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys, pickle
sys.path.insert(0, "src")
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed import compression as COMP
job = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((4,), ("pod",))

def f(g, r):
    out, new_r = COMP.compressed_psum({"w": g.reshape(g.shape[1:])},
                                      {"w": r.reshape(r.shape[1:])}, "pod")
    return out["w"][None], new_r["w"][None]

res = []
with jax.set_mesh(mesh):
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                               out_specs=(P("pod"), P("pod"))))
    for g, r in job["cases"]:
        out, nr = fn(g, r)
        res.append((np.asarray(out), np.asarray(nr)))
pickle.dump({"res": res, "devices": jax.device_count()},
            open(sys.argv[2], "wb"))
"""

_TORCH = r"""
import sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import _mesh_ranks
from repro_torch.launch.mesh import spawn
spawn(_mesh_ranks.psum, 4, device="cpu", args=(sys.argv[1],))
"""


def _run(script, *args):
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_compressed_psum_four_ranks_bit_for_bit(tmp_path):
    """Per-pod distinct gradients (the reference test's linspace ramps,
    zero residuals) and a random case with residuals: every rank's mean
    and new residual equal the reference pod's bit for bit, the mean is
    the same on every rank, and within the int8 error of the true mean."""
    g = np.stack([np.linspace(-1, 1, 64, dtype=np.float32) * (i + 1)
                  for i in range(4)])
    rng = np.random.default_rng(0)
    cases = [(g, np.zeros_like(g)),
             (rng.standard_normal((4, 3, 50)).astype(np.float32),
              (rng.standard_normal((4, 3, 50)) * 1e-2).astype(np.float32))]
    job = tmp_path / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"cases": cases, "out": str(tmp_path / "torch.pkl")}, f)
    _run(_JAX, job, tmp_path / "jax.pkl")
    _run(_TORCH, job)
    ref = pickle.load(open(tmp_path / "jax.pkl", "rb"))
    got = pickle.load(open(tmp_path / "torch.pkl", "rb"))
    assert ref["devices"] == 4 and got["world"] == 4
    for (jm, jr), (tm, tr) in zip(ref["res"], got["res"]):
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tr, jr)
        assert all(np.array_equal(tm[0], tm[i]) for i in range(4))
    err = float(np.abs(got["res"][0][0][0] - g.mean(0)).max())
    assert err < 0.05, err
