"""Config fingerprints of fitted oracles.

Only :func:`config_fingerprint` is ported so far: the serving layer keys
its cache epochs on it. The versioned artifact store of
``repro.api.artifacts`` comes with a later slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from repro_torch.core.predictor import ProfetConfig


def config_fingerprint(config: ProfetConfig) -> str:
    """Stable digest over every config field (member set, epochs, seed, ...)."""
    payload = json.dumps(dataclasses.asdict(config), sort_keys=True,
                         default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]
