"""The port's GPipe stages (``repro_torch.distributed.pipeline``) against
the sequential application and the reference's ``pipeline_apply``: the
reference test's L, B, D, M = 8, 12, 16, 6 blocks of ``tanh(h @ w + b)``
over a 4-stage ``("pod",)`` mesh, the port on 4 ``gloo`` ranks and the
reference on 4 forced host devices, each in a subprocess, from the same
numpy inputs; and ``bubble_fraction``."""
import pickle
import subprocess
import sys

import numpy as np
import torch

from repro.distributed.pipeline import bubble_fraction as j_bubble
from repro_torch.distributed.pipeline import bubble_fraction

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
L, B, D, M = 8, 12, 16, 6

_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys, pickle
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
job = pickle.load(open(sys.argv[1], "rb"))
params = {k: jnp.asarray(v) for k, v in job["params"].items()}

def block(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])

mesh = jax.make_mesh((4,), ("pod",))
out = jax.jit(lambda p, x: pipeline_apply(
    block, p, x, mesh=mesh, axis="pod",
    microbatches=job["microbatches"]))(params, jnp.asarray(job["x"]))
pickle.dump({"out": np.asarray(out), "devices": jax.device_count()},
            open(sys.argv[2], "wb"))
"""

_TORCH = r"""
import sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import _mesh_ranks
from repro_torch.launch.mesh import spawn
spawn(_mesh_ranks.pipeline, 4, device="cpu", args=(sys.argv[1],))
"""


def _run(script, *args):
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_pipeline_matches_sequential_and_reference(tmp_path):
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((B, D)).astype(np.float32)
    job = tmp_path / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"params": params, "x": x, "microbatches": M,
                     "out": str(tmp_path / "torch.pkl")}, f)
    _run(_TORCH, job)
    _run(_JAX, job, tmp_path / "jax.pkl")
    got = pickle.load(open(tmp_path / "torch.pkl", "rb"))
    ref = pickle.load(open(tmp_path / "jax.pkl", "rb"))
    assert got["world"] == 4 and ref["devices"] == 4
    # sequential: the same blocks, layer by layer, microbatch by microbatch
    h = torch.from_numpy(x).reshape(M, B // M, D)
    seq = []
    for m in range(M):
        hm = h[m]
        for i in range(L):
            hm = torch.tanh(hm @ torch.from_numpy(params["w"][i])
                            + torch.from_numpy(params["b"][i]))
        seq.append(hm)
    seq = torch.cat(seq).numpy()
    for r in range(4):   # the result is on every stage, bit for bit
        np.testing.assert_array_equal(got["out"][r], seq)
    np.testing.assert_allclose(got["out"][0], ref["out"], atol=1e-5)


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 12) == 3 / 15
    assert 0 < bubble_fraction(2, 2) < 1
    for s, m in ((4, 6), (2, 16), (16, 1)):
        assert bubble_fraction(s, m) == j_bubble(s, m)
