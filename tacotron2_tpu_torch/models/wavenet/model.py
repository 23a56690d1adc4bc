"""WaveNet vocoder, synthesis side (PyTorch).

Counterpart of tacotron2_tpu/models/wavenet/model.py for serving: the
conditioning upsample `WaveNet.upsample` (:85). The sample loop is
`models/wavenet/sampler.py` (plain) / the CUDA sampler kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import Config
from .modules import UpsampleNetwork


class WaveNet(nn.Module):
    """Holds the upsample network; weights come from `convert.py`."""

    def __init__(self, cfg: Config):
        super().__init__()
        wn = cfg.wavenet
        assert wn.cin_channels > 0 and wn.upsample_type == "SubPixel", \
            "the port covers the SubPixel-conditioned vocoder"
        self.cfg = cfg
        self.upsample_network = UpsampleNetwork(
            tuple(wn.upsample_scales), wn.freq_axis_kernel_size,
            wn.upsample_activation, wn.leaky_alpha)

    @torch.no_grad()
    def upsample(self, c):
        """Mel [B, T_mel, M] -> sample-rate features [B, T_mel·hop, M]."""
        return self.upsample_network(c)
