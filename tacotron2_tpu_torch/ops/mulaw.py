"""μ-law companding and input-type predicates (numpy or torch).

The port's copy of tacotron2_tpu/ops/mulaw.py:19-65 (reference
wavenet_vocoder/util.py:10-120): `mulaw`, `inv_mulaw`, `mulaw_quantize`,
`inv_mulaw_quantize` and the `is_*` predicates that dispatch on
`wavenet.input_type`. The functions take numpy arrays or torch tensors and
return the same kind.
"""

from __future__ import annotations

import numpy as np
import torch


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def mulaw(x, mu: int = 255):
    """[-1, 1] → [-1, 1] companded: sign(x)·ln(1+μ|x|)/ln(1+μ)."""
    xp = _xp(x)
    return xp.sign(x) * xp.log1p(mu * xp.abs(x)) / np.log1p(np.float32(mu))


def inv_mulaw(y, mu: int = 255):
    """Inverse companding: sign(y)·((1+μ)^|y| − 1)/μ."""
    xp = _xp(y)
    return xp.sign(y) * (1.0 / mu) * ((1.0 + mu) ** xp.abs(y) - 1.0)


def mulaw_quantize(x, mu: int = 255):
    """[-1, 1] → int in [0, μ]. Truncates like the reference (silence
    quantizes to 127), not round-to-nearest."""
    y = (mulaw(x, mu) + 1.0) / 2.0 * mu
    return y.to(torch.int32) if isinstance(y, torch.Tensor) \
        else y.astype(np.int32)


def inv_mulaw_quantize(y, mu: int = 255):
    """int [0, μ] → [-1, 1]."""
    y = y.to(torch.float32) if isinstance(y, torch.Tensor) \
        else np.asarray(y).astype(np.float32)
    return inv_mulaw(2.0 * y / mu - 1.0, mu)


def is_mulaw_quantize(input_type: str) -> bool:
    return input_type == "mulaw-quantize"


def is_mulaw(input_type: str) -> bool:
    return input_type == "mulaw"


def is_raw(input_type: str) -> bool:
    return input_type == "raw"


def is_scalar_input(input_type: str) -> bool:
    return is_raw(input_type) or is_mulaw(input_type)
