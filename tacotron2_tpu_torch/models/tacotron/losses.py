"""Tacotron loss assembly (PyTorch).

Counterpart of tacotron2_tpu/models/tacotron/losses.py `compute_losses`
(:115) for the default trainer flags: before and after MSE (masked or not,
as `mask_decoder` says), the stop-token cross-entropy on logits, the L2
regularisation with the reference's name-based exclusions over the
flax-named parameters (:95-113) and `tacotron_scale_regularization`, the
style-embedding softmax cross-entropy of both classifier heads, and the
orthogonality term 0.02·‖E_emt·E_spkᵀ‖_F. The unpaired, nat-GAN,
adversarial and pretrained-discriminator terms are not ported: their
flags raise (`train/tacotron_step.py`), and their entries read 0 here, as
they do in JAX with those flags off.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

from ...config import Config

# parameter-path tokens the L2 term leaves out (tacotron.py:862-867)
L2_EXCLUDED = ("bias", "projection", "inputs_embedding", "lstm", "rnn", "gru",
               "fw", "bw")
# the JAX terms that stay 0 without the unported flags
ZERO_TERMS = ("linear_loss", "style_emb_loss_up_emt", "style_emb_loss_up_spk",
              "style_emb_loss_mel_out_up_emt",
              "style_emb_loss_mel_out_up_spk", "g_loss_p", "g_loss_up",
              "d_loss")


def sequence_mask(lengths, max_len: int):
    """[B] -> [B, max_len] float mask of t < length."""
    t = torch.arange(max_len, device=lengths.device)[None, :]
    return (t < lengths[:, None]).float()


def masked_mse(targets, outputs, lengths):
    """MaskedMSE (modules.py:532-551)."""
    mask = sequence_mask(lengths, targets.shape[1])[:, :, None].expand_as(
        targets)
    se = (targets - outputs) ** 2 * mask
    return se.sum() / mask.sum().clamp(min=1.0)


def masked_stop_ce(targets, logits, lengths, pos_weight: float = 1.0):
    """MaskedSigmoidCrossEntropy (modules.py:553-575): weighted BCE on
    logits, averaged over the nonzero in-mask positions."""
    mask = sequence_mask(lengths, targets.shape[1])
    log_w = 1.0 + (pos_weight - 1.0) * targets
    losses = ((1.0 - targets) * logits
              + log_w * (torch.log1p(torch.exp(-logits.abs()))
                         + torch.relu(-logits)))
    masked = losses * mask
    return masked.sum() / (masked != 0).float().sum().clamp(min=1.0)


def stop_ce(targets, logits):
    """Unmasked sigmoid cross-entropy (the default, tacotron.py:778-779)."""
    return (torch.relu(logits) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def softmax_ce(logits, labels):
    """Mean softmax cross-entropy against integer labels."""
    return -F.log_softmax(logits, -1).gather(
        -1, labels.long()[:, None]).mean()


def l2_regularization(named_params: Iterable[Tuple[str, torch.Tensor]],
                      reg_weight: float):
    """reg_weight · Σ 0.5·‖W‖² over the parameters whose flax path (lower
    case) holds none of L2_EXCLUDED."""
    total = 0.0
    for name, p in named_params:
        if not any(tok in name.lower() for tok in L2_EXCLUDED):
            total = total + 0.5 * (p.float() ** 2).sum()
    return total * reg_weight


def compute_losses(out: Dict, batch: Dict, named_params, cfg: Config
                   ) -> Dict[str, torch.Tensor]:
    """Every loss term, 'loss' (the optimizer's target) and 'loss_no_mo_up'
    (equal to it without the unpaired terms). `out` is
    `Tacotron.forward`'s dict, `batch` holds mel_targets,
    stop_token_targets, targets_lengths, emt_labels and spk_labels as
    tensors, `named_params` the (flax path, parameter) pairs of
    `convert.flax_named_parameters`."""
    tc, gst, au = cfg.tacotron, cfg.gst, cfg.audio
    tgt = batch["mel_targets"]
    if tc.mask_decoder:
        lengths = batch["targets_lengths"]
        before = masked_mse(tgt, out["decoder_output"], lengths)
        after = masked_mse(tgt, out["mel_outputs"], lengths)
        stop = masked_stop_ce(batch["stop_token_targets"],
                              out["stop_token_prediction"], lengths,
                              tc.cross_entropy_pos_weight)
    else:
        before = ((tgt - out["decoder_output"]) ** 2).mean()
        after = ((tgt - out["mel_outputs"]) ** 2).mean()
        stop = stop_ce(batch["stop_token_targets"],
                       out["stop_token_prediction"])
    reg_weight = cfg.train.tacotron_reg_weight
    if cfg.train.tacotron_scale_regularization:
        reg_weight *= (1.0 / (2 * au.max_abs_value) if au.symmetric_mels
                       else 1.0 / au.max_abs_value)
    zero = tgt.new_zeros(())
    reg = l2_regularization(named_params, reg_weight) + zero
    style_emt = style_spk = orthog = zero
    if out.get("style_emb_logit_emt") is not None:
        style_emt = softmax_ce(out["style_emb_logit_emt"], batch["emt_labels"])
        style_spk = softmax_ce(out["style_emb_logit_spk"], batch["spk_labels"])
    if gst.use_orthog_loss and not gst.adain:
        orthog = 0.02 * torch.linalg.norm(
            out["refnet_out_emt"] @ out["refnet_out_spk"].t())
    loss = before + after + stop + reg + style_emt + style_spk + orthog
    terms = dict(before_loss=before, after_loss=after, stop_token_loss=stop,
                 regularization_loss=reg, style_emb_loss_emt=style_emt,
                 style_emb_loss_spk=style_spk, style_emb_orthog_loss=orthog)
    terms.update({k: zero for k in ZERO_TERMS})
    terms.update(loss_no_mo_up=loss, loss=loss)
    return terms
