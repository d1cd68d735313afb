"""Versioned on-disk artifacts for fitted oracles.

Every artifact is an envelope carrying a schema version and a
:class:`ProfetConfig` fingerprint, so a cache written under different
settings (``dnn_epochs``, ``seed``, member set, ...) is rejected instead of
silently reused.

    from repro_torch import api
    api.save(oracle, "results/oracle.pkl")
    oracle = api.load("results/oracle.pkl", expect_config=cfg, device="cpu")

The envelope persists state, not objects: the fitted model as
:func:`repro_torch.convert.profet_to_numpy` gives it (forests as their
packed ``(feat, thr, left, right, value)`` arrays, DNN heads as float32
arrays copied off the device) and the dataset as lists and dicts of
strings and numbers. Nothing in it names a tensor or a device, so an
artifact saved on the card loads on the CPU and the other way round;
:func:`load` rebuilds the model on the ``device`` it is given.

Unpickling runs code named in the file, so :func:`load` unpickles through
:class:`_StateUnpickler`, which resolves only builtin containers, numpy
and ``repro_torch`` names. An artifact of another package (the JAX
reference's names its ``repro.*`` classes) raises :class:`ArtifactError`
before any of its modules is imported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import pickle
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.api.oracle import LatencyOracle
from repro_torch.api.types import ApiError
from repro_torch.convert import profet_from_numpy, profet_to_numpy
from repro_torch.core import simulator, workloads
from repro_torch.core.predictor import ProfetConfig

SCHEMA_VERSION = 1
MAGIC = "profet-oracle-torch"

# the only builtins an artifact's pickle stream may name
_BUILTINS = frozenset({"dict", "list", "tuple", "set", "frozenset", "int",
                       "float", "complex", "str", "bytes", "bytearray",
                       "bool", "slice", "range"})


class ArtifactError(ApiError):
    """Artifact missing, malformed, or incompatible with this code."""


class SchemaVersionError(ArtifactError):
    """Artifact written by an incompatible schema version."""


class FingerprintMismatchError(ArtifactError):
    """Artifact was fit under a different ProfetConfig than expected."""


class _StateUnpickler(pickle.Unpickler):
    """Resolves builtin containers and scalars, numpy (arrays, dtypes,
    scalars) and ``repro_torch`` names; any other global (another
    package's class, ``os.system``, ...) raises before its module is
    imported."""

    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if (module == "builtins" and name in _BUILTINS) \
                or root in ("numpy", "repro_torch"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not loaded from an artifact "
            "(only builtins, numpy and repro_torch names are)")


def config_fingerprint(config: ProfetConfig) -> str:
    """Stable digest over every config field (member set, epochs, seed,
    ...)."""
    payload = json.dumps(dataclasses.asdict(config), sort_keys=True,
                         default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def calibration_fingerprint(config: ProfetConfig, pairs, n_obs: int) -> str:
    """Epoch label for a live-calibrated candidate oracle: the base config
    fingerprint plus a ``+cal<digest>`` suffix over the refit pairs and the
    number of live observations folded in. Two candidates refit from the
    same config on different live evidence get different labels, and the
    ``+cal`` marker makes calibrated epochs recognisable in ``/statsz``.
    (The serving swap additionally uniquifies reused labels.)"""
    payload = json.dumps({"pairs": sorted(list(p) for p in pairs),
                          "n_obs": int(n_obs)}, sort_keys=True)
    digest = hashlib.sha256(payload.encode()).hexdigest()[:8]
    return f"{config_fingerprint(config)}+cal{digest}"


def _dataset_state(ds: workloads.Dataset) -> dict:
    """The dataset as lists and dicts of strings and numbers, measurement
    order kept."""
    return {"devices": list(ds.devices),
            "cases": [list(c) for c in ds.cases],
            "measurements": {
                d: [[m.model, m.batch, m.pix, dict(m.profile),
                     float(m.latency_ms)] for m in meas.values()]
                for d, meas in ds.measurements.items()}}


def _dataset_from_state(state: dict) -> workloads.Dataset:
    meas = {}
    for d, rows in state["measurements"].items():
        meas[d] = {(model, int(b), int(p)): simulator.Measurement(
            model=model, device=d, batch=int(b), pix=int(p),
            profile=dict(profile), latency_ms=float(lat))
            for model, b, p, profile, lat in rows}
    return workloads.Dataset(
        devices=tuple(state["devices"]),
        cases=[(c[0], int(c[1]), int(c[2])) for c in state["cases"]],
        measurements=meas)


def save(oracle: LatencyOracle, path: Union[str, pathlib.Path]) -> dict:
    """Write the oracle under a versioned envelope; returns the manifest.
    The write is atomic (tmp + rename): a crash mid-write leaves either
    the previous artifact or none, never a truncated pickle."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    manifest = {
        "magic": MAGIC,
        "schema_version": SCHEMA_VERSION,
        "fingerprint": config_fingerprint(oracle.config),
        "config": dataclasses.asdict(oracle.config),
        "devices": list(oracle.dataset.devices),
        "n_cases": len(oracle.dataset.cases),
        "pairs": [list(p) for p in oracle.pairs()],
        "forest_format": "packed-arrays",
    }
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump({**manifest,
                     "payload": {"profet": profet_to_numpy(oracle.profet),
                                 "dataset": _dataset_state(oracle.dataset)}},
                    f)
    os.replace(tmp, path)
    return manifest


def _check_packed_forests(path, state: dict) -> None:
    if "forest" not in state["config"]["members"]:
        return
    for p in state["pairs"]:
        forest = p.get("forest")
        if not isinstance(forest, dict) or any(
                k not in forest for k in ("feat", "thr", "left", "right",
                                          "value", "depth")):
            raise ArtifactError(
                f"{path}: pair ({p.get('anchor')!r}, {p.get('target')!r}) "
                "carries a non-packed forest member; only packed-array "
                "forests load — refit and re-save")


def load(path: Union[str, pathlib.Path],
         expect_config: Optional[ProfetConfig] = None,
         device="cuda") -> LatencyOracle:
    """Load an oracle onto ``device``, validating the envelope.

    ``expect_config`` (when given) must fingerprint-match the stored config;
    a mismatch raises :class:`FingerprintMismatchError` — callers treat that
    as a cache miss and refit.
    """
    path = pathlib.Path(path)
    if not path.exists():
        raise ArtifactError(f"no artifact at {path}")
    try:
        with open(path, "rb") as f:
            env = _StateUnpickler(f).load()
    except Exception as e:
        raise ArtifactError(f"unreadable artifact {path}: {e}") from e
    if not isinstance(env, dict) or env.get("magic") != MAGIC:
        raise ArtifactError(
            f"{path} is not a {MAGIC} artifact (legacy unversioned cache?)")
    if env.get("schema_version") != SCHEMA_VERSION:
        raise SchemaVersionError(
            f"{path}: schema v{env.get('schema_version')} != "
            f"supported v{SCHEMA_VERSION} — refit and re-save")
    if expect_config is not None:
        want = config_fingerprint(expect_config)
        if env.get("fingerprint") != want:
            raise FingerprintMismatchError(
                f"{path}: artifact config {env.get('fingerprint')} != "
                f"expected {want} — refit required")
    try:
        state, ds_state = env["payload"]["profet"], env["payload"]["dataset"]
        _check_packed_forests(path, state)
        dataset = _dataset_from_state(ds_state)
    except ArtifactError:
        raise
    except Exception as e:
        raise ArtifactError(f"malformed artifact {path}: "
                            f"{type(e).__name__}: {e}") from e
    return LatencyOracle(profet_from_numpy(state, device), dataset)


# ----------------------------------------------------------------------
# crash-safe calibration persistence
# ----------------------------------------------------------------------

def _epoch_filename(epoch: str) -> str:
    """A filesystem-safe artifact name for an epoch label (labels carry
    ``+`` suffixes and may be operator-supplied)."""
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in epoch)
    digest = hashlib.sha256(epoch.encode()).hexdigest()[:8]
    return f"cal_{safe[:48]}_{digest}.pkl"


class CalibrationStore:
    """Crash-safe persistence of live-calibration promotions (a restart
    must not forget a promoted calibration).

    Layout under ``root``: one versioned oracle artifact per promoted
    candidate (written via :func:`save`, so schema/fingerprint validation
    applies on recovery) plus an ``index.json`` journal of entries
    ``{epoch, file, status, ts}`` in promotion order. Both writes are
    atomic (tmp + rename) and ordered artifact-then-index, so a crash at
    any point leaves a readable store: at worst an orphaned artifact the
    index never references.

    ``record_promotion`` journals a promoted candidate under its served
    epoch (``{fp}+cal{hash}`` + any swap uniquification);
    ``record_rollback`` demotes it so recovery skips it; ``recover``
    returns the newest promoted-and-loadable oracle with its epoch, on
    ``device`` — entries that fail validation (e.g. a different config
    after a deploy) are skipped, not fatal."""

    INDEX = "index.json"
    PROMOTED = "promoted"
    ROLLED_BACK = "rolled_back"

    def __init__(self, root: Union[str, pathlib.Path]):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def _index_path(self) -> pathlib.Path:
        return self.root / self.INDEX

    def entries(self) -> List[Dict]:
        """The journal, oldest first; [] when absent or unreadable (a
        half-written store must not take recovery down)."""
        try:
            with open(self._index_path(), "r") as f:
                idx = json.load(f)
            entries = idx.get("entries", [])
            return entries if isinstance(entries, list) else []
        except (OSError, ValueError):
            return []

    def _write_entries(self, entries: List[Dict]) -> None:
        tmp = self._index_path().with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump({"magic": f"{MAGIC}-calibration-index",
                       "entries": entries}, f, indent=1)
        os.replace(tmp, self._index_path())

    def record_promotion(self, oracle: LatencyOracle,
                         epoch: str) -> pathlib.Path:
        """Persist a just-promoted candidate under its serving epoch."""
        fname = _epoch_filename(epoch)
        path = self.root / fname
        save(oracle, path)                     # atomic; then the journal
        with self._lock:
            entries = self.entries()
            entries.append({"epoch": epoch, "file": fname,
                            "status": self.PROMOTED,
                            "fingerprint": config_fingerprint(oracle.config),
                            "ts": time.time()})
            self._write_entries(entries)
        return path

    def record_rollback(self, epoch: str) -> bool:
        """Demote every journal entry for ``epoch`` (its canary regressed
        post-promotion); recovery will skip it. Returns True when an
        entry was demoted."""
        with self._lock:
            entries = self.entries()
            hit = False
            for e in entries:
                if e.get("epoch") == epoch \
                        and e.get("status") == self.PROMOTED:
                    e["status"] = self.ROLLED_BACK
                    hit = True
            if hit:
                self._write_entries(entries)
            return hit

    def latest(self) -> Optional[Dict]:
        """The newest still-promoted journal entry, or None."""
        for e in reversed(self.entries()):
            if e.get("status") == self.PROMOTED:
                return e
        return None

    def recover(self, expect_config: Optional[ProfetConfig] = None,
                device="cuda") -> Optional[Tuple[LatencyOracle, str]]:
        """Load the newest promoted candidate that still validates;
        ``(oracle, epoch)``, or None when nothing usable is stored."""
        for e in reversed(self.entries()):
            if e.get("status") != self.PROMOTED:
                continue
            try:
                oracle = load(self.root / str(e.get("file")),
                              expect_config=expect_config, device=device)
            except ArtifactError:
                continue
            return oracle, str(e.get("epoch"))
        return None


def fit_or_load(path: Union[str, pathlib.Path], config: ProfetConfig,
                fit_fn=None, device="cuda", **fit_kwargs) -> LatencyOracle:
    """Cache-through helper: load onto ``device`` when the artifact
    matches ``config``, otherwise (re)fit via ``fit_fn`` (default
    :meth:`LatencyOracle.fit` on ``device``) and overwrite the artifact."""
    try:
        return load(path, expect_config=config, device=device)
    except ArtifactError:
        pass
    fit = fit_fn or (lambda: LatencyOracle.fit(config=config, device=device,
                                               **fit_kwargs))
    oracle = fit()
    save(oracle, path)
    return oracle
