"""Carry models across as plain numpy state: a fitted PROFET model
(:func:`profet_from_numpy` / :func:`profet_to_numpy`), an LM's
parameters (:func:`lm_from_numpy` / :func:`lm_to_numpy`) and its AdamW
state (:func:`opt_state_from_numpy` / :func:`opt_state_to_numpy`).

A PROFET state is a dict of numpy arrays, strings, numbers, lists and dicts —
nothing framework-specific — so a model fitted by the JAX reference can be
rebuilt here (and a model fitted here moved to another device):

    {"config":   {ProfetConfig field: value},
     "features": {"names": [...], "clusters": [[...]], "max_height": h},
     "pairs":    [{"anchor": a, "target": t,
                   "linear": coef_ (D+1,),
                   "forest": {feat, thr, left, right, value, n_nodes,
                              "depth": int},
                   "dnn": {"params": [(w, b), ...], "mu": (D,), "sd": (D,),
                           "ys": float}}, ...],
     "scalers":  {"batch" | "pixel": {device: {"coef", "order",
                  "min_knob", "max_knob", "min_range"}}}}

A pair carries only the members the config names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.clustering import FeatureClustering
from repro_torch.core.ensemble import MedianEnsemble
from repro_torch.core.predictor import Profet, ProfetConfig
from repro_torch.core.regressors import (DNNRegressor, LinearRegressor,
                                         PackedForest, RandomForestRegressor)
from repro_torch.core.scaling import PolyScaler
from repro_torch.models.model import stacked

_SCALER_FIELDS = ("order", "min_knob", "max_knob", "min_range")


def profet_from_numpy(state: dict, device="cuda") -> Profet:
    """The fitted ``Profet`` that ``state`` describes, with its forest and
    DNN members on ``device``."""
    dev = resolve_device(device)
    cfg = dict(state["config"])
    cfg["members"] = tuple(cfg["members"])
    config = ProfetConfig(**cfg)
    profet = Profet(config, device=dev)
    f = state["features"]
    profet.features = FeatureClustering(
        names=list(f["names"]), clusters=[list(c) for c in f["clusters"]],
        max_height=float(f["max_height"]))
    for p in state["pairs"]:
        ens = MedianEnsemble(seed=config.seed, dnn_epochs=config.dnn_epochs,
                             n_trees=config.n_trees, members=config.members,
                             device=dev)
        for name in config.members:
            if name == "linear":
                model = LinearRegressor()
                model.coef_ = np.asarray(p["linear"], np.float64)
            elif name == "forest":
                model = RandomForestRegressor(n_estimators=config.n_trees,
                                              seed=config.seed, device=dev)
                model.forest_ = PackedForest.from_state(p["forest"])
            else:
                d = p["dnn"]
                model = DNNRegressor(epochs=config.dnn_epochs,
                                     seed=config.seed, device=dev)
                model.params = [
                    {"w": torch.from_numpy(np.asarray(w, np.float32)).to(dev),
                     "b": torch.from_numpy(np.asarray(b, np.float32)).to(dev)}
                    for w, b in d["params"]]
                model._stats = (np.asarray(d["mu"], np.float64),
                                np.asarray(d["sd"], np.float64),
                                float(d["ys"]))
            ens.models[name] = model
        profet.cross[(p["anchor"], p["target"])] = ens
    for kind, scalers in (("batch", profet.batch_scalers),
                          ("pixel", profet.pixel_scalers)):
        for dev_name, s in state["scalers"][kind].items():
            scalers[dev_name] = PolyScaler(
                order=int(s["order"]), min_knob=float(s["min_knob"]),
                max_knob=float(s["max_knob"]),
                min_range=float(s["min_range"]),
                coef=np.asarray(s["coef"], np.float64))
    return profet


def profet_to_numpy(profet: Profet) -> dict:
    """The inverse of :func:`profet_from_numpy` for a model of this
    package (tensors copied back to the host). A recursive
    ``core.reference`` forest is written as ``{"node_lists": ...}``, which
    :func:`profet_from_numpy` cannot rebuild."""
    pairs = []
    for (anchor, target), ens in sorted(profet.cross.items()):
        entry = {"anchor": anchor, "target": target}
        for name, model in ens.models.items():
            if name == "linear":
                entry["linear"] = np.array(model.coef_)
            elif name == "forest" and isinstance(model,
                                                 RandomForestRegressor):
                entry["forest"] = model.forest_.to_state()
            elif name == "forest":
                # a recursive forest (``core.reference``) has no packed
                # arrays: its node lists go in as builtins, and
                # ``profet_from_numpy`` (like ``api.load``) refuses them
                entry["forest"] = {"node_lists": [
                    [dataclasses.astuple(n) for n in tree]
                    for tree in model.trees_]}
            else:
                mu, sd, ys = model._stats
                entry["dnn"] = {
                    "params": [(layer["w"].cpu().numpy(),
                                layer["b"].cpu().numpy())
                               for layer in model.params],
                    "mu": np.array(mu), "sd": np.array(sd), "ys": float(ys)}
        pairs.append(entry)
    cfg = profet.cfg
    return {
        "config": {k: getattr(cfg, k) for k in cfg.__dataclass_fields__},
        "features": {"names": list(profet.features.names),
                     "clusters": [list(c) for c in profet.features.clusters],
                     "max_height": profet.features.max_height},
        "pairs": pairs,
        "scalers": {kind: {d: {**{k: getattr(s, k) for k in _SCALER_FIELDS},
                               "coef": np.array(s.coef)}
                           for d, s in scalers.items()}
                    for kind, scalers in (("batch", profet.batch_scalers),
                                          ("pixel", profet.pixel_scalers))},
    }


def _tensor(arr: np.ndarray, dev) -> torch.Tensor:
    """``arr`` as a tensor on ``dev``; a bfloat16 array (``ml_dtypes``, the
    reference's) goes through float32, exactly."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def _unstack(tree: dict, dev) -> dict:
    """A reference tree (every leaf under a tree of ``models.model.STACKED``
    stacked on a leading layer axis) as tensors on ``dev`` keyed by the
    port's parameter names (``<tree>.<i>.<rest>``)."""
    state = {}
    for key, arr in _flatten(tree):
        if stacked(key):
            top, rest = key.split(".", 1)
            for i in range(arr.shape[0]):
                state[f"{top}.{i}.{rest}"] = _tensor(arr[i], dev)
        else:
            state[key] = _tensor(arr, dev)
    return state


def _stack(named) -> dict:
    """The inverse of :func:`_unstack` for ``(name, tensor)`` pairs, copied
    to the host; bfloat16 tensors come back as float32 (numpy has no
    bfloat16; the widening is exact)."""
    tree: dict = {}
    per_layer: dict = {}
    for key, t in named:
        t = t.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if stacked(key):
            top, i, rest = key.split(".", 2)
            per_layer.setdefault(f"{top}.{rest}", {})[int(i)] = arr
        else:
            _set(tree, key, arr)
    for key, layers in per_layer.items():
        _set(tree, key, np.stack([layers[i] for i in range(len(layers))]))
    return tree


def lm_from_numpy(cfg, params: dict, device="cuda"):
    """The port's LM (``repro_torch.models.model``) holding ``params``, the
    reference's parameter tree as ``M.init`` returns it after
    ``np.asarray``: nested dicts of numpy arrays, every leaf under a
    layer tree (``"blocks"``, ``"cross_blocks"``, ``"encoder"``,
    ``"decoder"``, ``"groups"``, ``"extra"``) stacked on a leading layer
    axis. Dtypes are kept."""
    from repro_torch.models import model as M
    model = M.build(cfg, device="meta")
    model.load_state_dict(_unstack(params, resolve_device(device)),
                          assign=True)
    return model


def lm_to_numpy(model) -> dict:
    """The inverse of :func:`lm_from_numpy`: the reference's parameter tree
    of the port's LM, copied to the host."""
    return _stack(model.state_dict().items())


def opt_state_from_numpy(state: dict, device="cuda") -> dict:
    """The port's AdamW state (``repro_torch.train.optimizer``) holding the
    reference's ``{"m", "v", "step"}`` after ``np.asarray``: the moments are
    parameter trees (blocks stacked), ``step`` a scalar. Dtypes are kept;
    the moments are keyed by the port's parameter names."""
    dev = resolve_device(device)
    return {"m": _unstack(state["m"], dev), "v": _unstack(state["v"], dev),
            "step": torch.tensor(np.asarray(state["step"]), device=dev)}


def opt_state_to_numpy(state: dict) -> dict:
    """The inverse of :func:`opt_state_from_numpy`: the reference's
    optimizer state tree of the port's AdamW state, copied to the host."""
    return {"m": _stack(state["m"].items()), "v": _stack(state["v"].items()),
            "step": state["step"].cpu().numpy()}


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _set(tree: dict, key: str, value) -> None:
    *path, leaf = key.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[leaf] = value
