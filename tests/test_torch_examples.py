"""The port's examples (``examples/torch_*.py``) run on the CPU."""
import importlib.util
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_serving_example_serves_both_families_on_cpu(capsys):
    """``examples/torch_serving.py`` at its SMOKE sizes: every request of
    both models gets its 12 new tokens, each inside the vocabulary
    padding."""
    out = _example("torch_serving").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert [o["arch"] for o in out] == ["llama3.2-1b", "mamba2-130m"]
    for o in out:
        assert o["generated_tokens"] == 6 * 12
        assert all(len(toks) == 12 for toks in o["outputs"])
        assert all(isinstance(t, int) and t >= 0
                   for toks in o["outputs"] for t in toks)
        assert f"[{o['arch']}] 6 requests, 3 slots" in printed


def test_torch_advisor_example_ranks_the_catalog_on_cpu(capsys):
    """``examples/torch_advisor.py``: one advise call answers every target
    of the catalog, the anchor's row is its measured latency, and the
    TPU comes out fastest."""
    rows = _example("torch_advisor").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert [r.target for r in rows] == ["M60", "T4", "K80", "V100", "A10",
                                        "P100", "TPUv5e"]
    assert all(r.latency_ms > 0 for r in rows)
    assert min(rows, key=lambda r: r.latency_ms).target == "TPUv5e"
    assert "-> fastest: TPUv5e" in printed
