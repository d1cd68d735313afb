"""Small versions of the benchmark's cells for the CPU tests: each cell's
configuration file with the port's SMOKE sizes of its architecture in
place of the model section, and its traffic at 64 tokens a sequence."""
from __future__ import annotations

import copy
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench.lib import catalog  # noqa: E402

# the port's architecture of each configuration
ARCH = {"dbrx-132b-l1": "dbrx-132b", "mamba2-130m": "mamba2-130m"}
SEQ = 64


def small(cell: str, **model):
    """(configuration, traffic) of ``cell`` at the SMOKE sizes."""
    from repro_torch.configs.base import get_config
    wl = catalog.workload(cell)
    conf = copy.deepcopy(catalog.config(wl["config"]))
    m = dataclasses.asdict(get_config(ARCH[wl["config"]], smoke=True))
    m = {k: list(v) if isinstance(v, tuple) else v for k, v in m.items()}
    m.update(model)
    conf["model"] = m
    traffic = dict(catalog.traffic(wl["traffic"]), seq_len=SEQ)
    return conf, traffic


def cells():
    return [c["name"] for c in catalog.benchmark()["workloads"]]
