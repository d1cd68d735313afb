"""The port's architecture of each configuration that ``_small.ARCH`` and
``perfbench/tests/conftest.py`` do not name, so that every cell of
``BENCHMARK.json`` has its SMOKE size in the tests parametrised over the
cells; and each test starting with the program's counters empty."""
import pytest

from perfbench.tests import _small

_small.ARCH.setdefault("jamba2-3b", "jamba2-3b")


@pytest.fixture(autouse=True)
def _counters_drained():
    """A traced run on the CPU reads no device time, so its readers leave
    the program's counters (``repro_torch.spans``) undrained in the
    process; a later test in the same worker would read them as its own."""
    from repro_torch import spans
    spans.drain()
    yield
