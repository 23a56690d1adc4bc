"""WaveNet conditioning features.

Of tacotron2_tpu/data/wavenet_feeder.py only `interp_to_unit` (:35), which
synthesis needs; the training feeder comes with WaveNet training.
"""

from __future__ import annotations

from ..config import Config


def interp_to_unit(feats, cfg: Config):
    """[-max, max] (or [0, max]) → [0, 1] (reference _interp,
    feeder.py:427). Works on numpy arrays and torch tensors."""
    lo = -cfg.audio.max_abs_value if cfg.audio.symmetric_mels else 0.0
    return (feats - lo) / (cfg.audio.max_abs_value - lo)
