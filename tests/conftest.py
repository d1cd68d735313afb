import os

# Tests see the real (single) CPU device — the 512-device override is ONLY
# for the dry-run entry point. Keep compilation deterministic + quiet.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with its reason "
        "where torch.cuda.is_available() is False")
