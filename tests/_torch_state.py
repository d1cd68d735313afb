"""Shared helpers of the ``tests/test_torch_*.py`` parity suite: carry a
model fitted by the JAX reference (``repro``) into the PyTorch port
(``repro_torch``) as plain numpy state, and fit small reference oracles."""
import dataclasses

import numpy as np

from repro.api.oracle import LatencyOracle
from repro.core import workloads
from repro.core.predictor import ProfetConfig

SMALL_DEVICES = ("T4", "V100")
SMALL_MODELS = ("LeNet5", "AlexNet", "ResNet18")

_SCALER_FIELDS = ("order", "min_knob", "max_knob", "min_range")


def state_from_repro(profet) -> dict:
    """The ``repro_torch.convert.profet_from_numpy`` state of a fitted
    ``repro`` Profet: numpy arrays, strings and numbers only."""
    pairs = []
    for (anchor, target), ens in sorted(profet.cross.items()):
        entry = {"anchor": anchor, "target": target}
        for name, model in ens.models.items():
            if name == "linear":
                entry["linear"] = np.array(model.coef_)
            elif name == "forest":
                entry["forest"] = {k: np.array(v) if k != "depth" else int(v)
                                   for k, v in model.forest_.to_state().items()}
            else:
                mu, sd, ys = model._stats
                entry["dnn"] = {
                    "params": [(np.array(layer["w"]), np.array(layer["b"]))
                               for layer in model.params],
                    "mu": np.array(mu), "sd": np.array(sd), "ys": float(ys)}
        pairs.append(entry)
    return {
        "config": dataclasses.asdict(profet.cfg),
        "features": {"names": list(profet.features.names),
                     "clusters": [list(c) for c in profet.features.clusters],
                     "max_height": float(profet.features.max_height)},
        "pairs": pairs,
        "scalers": {kind: {d: {**{k: getattr(s, k) for k in _SCALER_FIELDS},
                               "coef": np.array(s.coef)}
                           for d, s in scalers.items()}
                    for kind, scalers in (("batch", profet.batch_scalers),
                                          ("pixel", profet.pixel_scalers))},
    }


def small_dataset():
    return workloads.generate(devices=SMALL_DEVICES, models=SMALL_MODELS)


def fit_small_repro(members, n_trees=8, dnn_epochs=4, seed=0):
    """A small reference oracle: 2 devices, 3 models, few trees/epochs."""
    cfg = ProfetConfig(members=tuple(members), n_trees=n_trees,
                       dnn_epochs=dnn_epochs, seed=seed)
    return LatencyOracle.fit(small_dataset(), cfg)


def lm_pair(arch: str, dtype: str = "float32", seed: int = 0, **overrides):
    """A smoke-size LM of both packages with the same parameters: the
    reference's ``(cfg, params)`` from ``jax.random`` and the port's
    ``(cfg, model)`` carried across by ``repro_torch.convert.lm_from_numpy``
    on the CPU. ``dtype`` is the activations' dtype; ``overrides`` replace
    config fields in both."""
    import jax

    from repro.configs import base as CB
    from repro.models import model as JM
    from repro_torch.configs import base as TCB
    from repro_torch.convert import lm_from_numpy

    jcfg = dataclasses.replace(CB.get_config(arch, smoke=True), dtype=dtype,
                               **overrides)
    tcfg = dataclasses.replace(TCB.get_config(arch, smoke=True), dtype=dtype,
                               **overrides)
    params, _ = JM.init(jax.random.PRNGKey(seed), jcfg)
    model = lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                          device="cpu")
    return jcfg, params, tcfg, model


def dataset_from_repro(ds):
    """The port's ``Dataset`` holding the same measurements as the
    reference's ``ds`` (same devices, cases and order)."""
    from repro_torch.core import simulator as tsim
    from repro_torch.core import workloads as tw
    return tw.Dataset(
        devices=tuple(ds.devices), cases=list(ds.cases),
        measurements={d: {c: tsim.Measurement(**dataclasses.asdict(m))
                          for c, m in meas.items()}
                      for d, meas in ds.measurements.items()})


def carry_oracle(ref_oracle, device="cpu"):
    """The port's ``LatencyOracle`` on ``device`` holding the reference
    oracle's fitted model and dataset."""
    from repro_torch.api.oracle import LatencyOracle as TorchOracle
    from repro_torch.convert import profet_from_numpy
    return TorchOracle(profet_from_numpy(state_from_repro(ref_oracle.profet),
                                         device=device),
                       dataset_from_repro(ref_oracle.dataset))
