"""The benchmark's files, found by name: every cell's configuration,
traffic and limits, every per-layer metric's reader, every configuration's
reference family; and the configurations against the port's own."""
from __future__ import annotations

import dataclasses
import json
import re

import pytest

from perfbench.tests._small import ROOT, cells
from perfbench.lib import catalog, compare
from perfbench.reference import train as RT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = catalog.benchmark()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", cells())
def test_cell_files_resolve(cell):
    wl = catalog.workload(cell)
    assert NAME.match(cell) and NAME.match(wl["traffic"])
    assert wl["chips"] == 1 and 1 <= len(wl["why"]) <= 200
    conf = catalog.config(wl["config"])
    traffic = catalog.traffic(wl["traffic"])
    assert conf["name"] == wl["config"]
    assert traffic["global_batch"] % traffic["microbatches"] == 0
    assert traffic["compare_steps"] >= 2 and traffic["trace_steps"] >= 1
    limits = catalog.limits(cell)
    assert limits and all(0 < v < 1 for v in limits.values())
    # every number is compared or named with the reason it is not
    named = json.loads((catalog.BENCH_DIR / "limits" / f"{cell}.json")
                       .read_text())["not_compared"]
    assert sorted([*limits, *named]) == sorted(compare.NUMBERS)
    assert RT.family(conf["model"]["family"]).accumulate_grads
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = {m["name"] for m in catalog.metrics_of(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert catalog.metrics_of(cell, "per_layer")


def test_configs_entries_match_their_files():
    used = {wl["config"] for wl in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        conf = catalog.config(c["name"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
        assert c["source"] == conf["source"] or c["source"] in conf["source"]


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics_well_formed(section):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[section]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e
            assert set(m["workloads"]) <= set(cells())
            assert callable(catalog.reader(m["name"]))
    if section == "end_to_end":
        assert "setup_s" in e2e


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_ports_but_for_reduced(name):
    """The configuration file's model section is the port's registered
    configuration, every width as published, but for the keys it lists as
    reduced."""
    from repro_torch.configs.base import get_config
    from perfbench.tests._small import ARCH
    from perfbench.lib.cell import model_config
    conf = catalog.config(name)
    ours = dataclasses.asdict(model_config(conf["model"]))
    port = dataclasses.asdict(get_config(ARCH[name]))
    differ = {k for k in ours if ours[k] != port[k]} - {"name"}
    assert differ == set(conf["reduced"])


def test_reader_of_a_dotted_name(tmp_path, monkeypatch):
    """A metric named with a dot (``dispatch_ms.train``) is found by its
    file name."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dispatch_ms.train.py").write_text(
        "def read(run):\n    return 1.5\n")
    monkeypatch.setattr(catalog, "BENCH_DIR", tmp_path)
    assert catalog.reader("dispatch_ms.train")(None) == 1.5
