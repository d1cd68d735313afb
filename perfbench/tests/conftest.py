"""The port's architecture of each configuration that ``_small.ARCH``
does not name, so that every cell of ``BENCHMARK.json`` has its SMOKE
size in the tests parametrised over the cells."""
from perfbench.tests import _small

_small.ARCH.setdefault("granite-4.0-h-small-p1", "granite-4.0-h-small")
