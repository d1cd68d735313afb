"""On the card: the frozen sequential DNN fit (``repro_torch.core.reference.
fit_dnn_sequential``) against its own run on the CPU.

The test needs an NVIDIA GPU and skips without one. The file imports no
JAX, so on a GPU machine it runs with ``--noconftest``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_reference_cuda.py

Both runs start from the same seeded init (drawn on the CPU) and take the
same minibatches; the card sums in another order, so the trained weights
stay within 1e-5 of each layer's largest weight (the bar of
``tests/test_torch_reference.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import reference as P

pytestmark = pytest.mark.cuda


def test_fit_dnn_sequential_on_the_card_tracks_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's run is the subject")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(70, 9))
    y = np.abs(X[:, 0]) * 3 + X[:, 1] ** 2 + 1
    kw = dict(epochs=4, batch_size=32, seed=3)
    card = P.fit_dnn_sequential(X, y, device="cuda", **kw)
    cpu = P.fit_dnn_sequential(X, y, device="cpu", **kw)
    assert card.params[0]["w"].is_cuda
    assert card._stats[2] == cpu._stats[2]
    for la, lb in zip(cpu.params, card.params):
        for k in ("w", "b"):
            wa = la[k].numpy()
            np.testing.assert_allclose(lb[k].cpu().numpy(), wa, rtol=0,
                                       atol=1e-5 * np.abs(wa).max())
    Xq = rng.normal(size=(13, 9))
    np.testing.assert_allclose(card.predict(Xq), cpu.predict(Xq), rtol=1e-5)
