"""Style discriminators on the shared reference encoder (PyTorch).

Counterpart of tacotron2_tpu/disc/model.py (reference code/spk_disc/
{model.py,utils.py}, emt_disc/networks.py):

- `DiscriminatorModel`: the Tacotron's `ReferenceEncoder` at the config's
  GST widths (named `pretrained_ref_enc`, the subtree that the Tacotron
  graft takes into `pretrained_ref_enc_{emt,spk}`), its embedding L2-
  normalised (`normalize`, 1e-6 inside the square root), then either the
  CE head `pretrained_ref_enc_dense` or, for GE2E, the scale `w` (10 at
  init) and bias `b` (-5) of the similarity matrix;
- `EmtDisc`: the standalone emotion classifier, a full-size reference
  encoder ((32, 32, 64, 64, 128, 128), GRU 128; `emt_disc`) and a logit
  head (`emt_disc_logit`), with no normalisation;
- `similarity_matrix` (GE2E eq. 9 with the leave-one-out centre over
  max(M - 1, 1)), `ge2e_loss` (softmax and contrast, sums over the N·M
  rows) and `disc_ce_loss` (mean CE and accuracy).

Parameter names follow `convert.flax_path`, so `convert.disc_to_flax` /
`load_disc` map the flax trees both ways. Each forward starts and ends by
dropping BatchNorm's traced statistics (`modules.clear_live`); in train
mode the running statistics move as flax's `mutable=["batch_stats"]`
returns them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..models.tacotron.modules import REF_EMB, Dense, ReferenceEncoder, \
    clear_live

EMT_DISC_FILTERS = (32, 32, 64, 64, 128, 128)


def normalize(x, dim: int = -1):
    return x / torch.sqrt(torch.sum(x ** 2, dim=dim, keepdim=True) + 1e-6)


class DiscriminatorModel(nn.Module):
    """ReferenceEncoder -> normalised embedding (+ the CE head)."""

    def __init__(self, cfg: Config, output_classes: int,
                 discriminator: bool = True, num_mels: int | None = None):
        super().__init__()
        gst = cfg.gst
        self.discriminator = discriminator
        # the input's mel count: the config's, or a TI-SV stack's (the
        # flax module takes its width from the first batch)
        self.pretrained_ref_enc = ReferenceEncoder(
            num_mels or cfg.audio.num_mels, tuple(gst.reference_filters),
            gst.reference_depth)
        if discriminator:
            self.pretrained_ref_enc_dense = Dense(REF_EMB, output_classes)
        else:
            self.w = nn.Parameter(torch.full((1,), 10.0))
            self.b = nn.Parameter(torch.full((1,), -5.0))

    def forward(self, mels, train: bool = False):
        """mels [B, T, num_mels] -> (embedding [B, 128], logits or None)."""
        clear_live(self)
        try:
            emb = normalize(self.pretrained_ref_enc(mels, train))
        finally:
            clear_live(self)
        if self.discriminator:
            return emb, self.pretrained_ref_enc_dense(emb)
        return emb, None


class EmtDisc(nn.Module):
    """The standalone CNN+GRU emotion classifier (emt_disc/networks.py)."""

    def __init__(self, cfg: Config, n_classes: int = 4):
        super().__init__()
        self.emt_disc = ReferenceEncoder(cfg.audio.num_mels,
                                         EMT_DISC_FILTERS, 128)
        self.emt_disc_logit = Dense(REF_EMB, n_classes)

    def forward(self, mels, train: bool = False):
        clear_live(self)
        try:
            emb = self.emt_disc(mels, train)
        finally:
            clear_live(self)
        return emb, self.emt_disc_logit(emb)


def similarity_matrix(embedded, w, b, N: int, M: int) -> torch.Tensor:
    """GE2E eq. (9): S [N·M, N], S[j·M + m, i] = |w|·e[j,m]·c[i] + b with
    the leave-one-out centre of its own class (utils.py:129-153)."""
    P = embedded.shape[-1]
    e = embedded.reshape(N, M, P)
    center = normalize(e.mean(dim=1))                               # [N, P]
    center_except = normalize((e.sum(dim=1, keepdim=True) - e)
                              / max(M - 1, 1))                      # [N, M, P]
    sim_all = torch.einsum("jmp,ip->jmi", e, center)                # [N, M, N]
    sim_self = (e * center_except).sum(-1)                          # [N, M]
    eye = torch.eye(N, device=e.device, dtype=e.dtype)[:, None, :]
    S = sim_all * (1 - eye) + sim_self[:, :, None] * eye
    S = torch.abs(w) * S + b
    return S.reshape(N * M, N)


def ge2e_loss(S, N: int, M: int, loss_type: str = "softmax") -> torch.Tensor:
    """GE2E eq. (6) softmax / (7) contrast, summed (utils.py:156-174)."""
    idx = torch.arange(N, device=S.device)
    S_correct = S.reshape(N, M, N)[idx, :, idx].reshape(N * M)
    if loss_type == "softmax":
        return -torch.sum(S_correct - torch.log(torch.exp(S).sum(1) + 1e-6))
    if loss_type == "contrast":
        sig = torch.sigmoid(S)
        mask = torch.kron(torch.eye(N, device=S.device, dtype=S.dtype),
                          torch.ones(M, 1, device=S.device, dtype=S.dtype))
        return torch.sum(1 - torch.sigmoid(S_correct)
                         + torch.amax(sig * (1 - mask), dim=1))
    raise ValueError("loss type should be softmax or contrast")


def disc_ce_loss(logits, labels, n_classes: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean softmax cross-entropy and accuracy (model.py:63-69)."""
    labels = labels.long()
    oh = F.one_hot(labels, n_classes).to(logits.dtype)
    loss = torch.mean(-torch.sum(oh * F.log_softmax(logits, -1), -1))
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc
