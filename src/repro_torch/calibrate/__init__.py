"""repro_torch.calibrate — streaming live-calibration over the serving
stack, the port of ``repro.calibrate``.

A control plane that makes ``repro_torch.serve`` self-correcting:
client-measured latencies stream in (``POST /measure`` or the advise
path), per-pair rolling MAPE detects drift, drifted pairs are refit in the
background into a candidate oracle, a shadow canary scores the candidate
on mirrored live traffic and held-out truth, and the candidate is promoted
through the warm-up-aware epoch swap only if it wins — with an automatic
rollback re-swap if live error regresses after promotion.

The candidate is fit on its incumbent's device, so on the card its bank,
canary predictions and warm-up run the forest kernels there; the control
logic itself is numpy and the standard library.
"""
from repro_torch.calibrate.buffer import MeasurementBuffer
from repro_torch.calibrate.canary import CanaryReport, heldout_scores, verdict
from repro_torch.calibrate.controller import Calibrator
from repro_torch.calibrate.drift import DriftDetector
from repro_torch.calibrate.refit import (RefitReport, build_candidate,
                                   calibrated_latencies)
from repro_torch.calibrate.types import (STATE_CONFIRM, STATE_IDLE,
                                         STATE_SHADOW, CalibrationConfig,
                                         CalibrationStats, Observation,
                                         pair_label)

__all__ = [
    "Calibrator", "CalibrationConfig", "CalibrationStats", "Observation",
    "MeasurementBuffer", "DriftDetector", "RefitReport", "build_candidate",
    "calibrated_latencies", "CanaryReport", "heldout_scores", "verdict",
    "pair_label", "STATE_IDLE", "STATE_SHADOW", "STATE_CONFIRM",
]
