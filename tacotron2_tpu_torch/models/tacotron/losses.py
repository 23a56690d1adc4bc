"""Tacotron loss assembly (PyTorch).

Counterpart of tacotron2_tpu/models/tacotron/losses.py `compute_losses`
(:115-268): before and after MSE (masked or not, as `mask_decoder` says),
the stop-token cross-entropy on logits, the L2 regularisation with the
reference's name-based exclusions over the flax-named parameters
(:95-113) and `tacotron_scale_regularization`, the style-embedding
softmax cross-entropy of both classifier heads and, with `adv_emb_disc`,
of the adversarial heads against the other label; the unpaired pass's
terms (its own heads on the crossed references' labels, and the heads on
`mel_outputs_up`, derated by `unpaired_loss_derate`), or under
`pretrained_emb_disc_all` the cosine terms between the crossed references'
embeddings and those of `mel_outputs_up`; the orthogonality term
0.02·‖E_emt·E_spkᵀ‖_F over both passes (none under `emt_only` or AdaIN),
which emt_attn replaces by `l2_spk_emb`'s 0.1·‖E_spk‖_F (:204-215); the
linear L1 loss of `predict_linear`, masked or not (:66-78,143-149);
nat-GAN's 3-class discriminator loss `d_loss` with its 0.1-weighted
emotion and speaker heads, and the generator terms `g_loss_p` /
`g_loss_up` derated by `nat_gan_derate`; `loss` and `loss_no_mo_up` as
JAX assembles them.

In a data-parallel step (`parallel.dist.activate`) every term is the
rank's share of the global batch's term, so that the shares sum to it
over the group and so do their gradients: means divide by the global
batch's count (the masked ones by counts all-reduced without gradient),
the whole-batch norms and cosines take their sums over the group, and a
term computed whole on every rank (the L2 term, the norms, the cosines)
is counted once (`dist.once`). Outside a step each is the one-process
term.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

from ...config import Config
from ...parallel import dist

# parameter-path tokens the L2 term leaves out (tacotron.py:862-867)
L2_EXCLUDED = ("bias", "projection", "inputs_embedding", "lstm", "rnn", "gru",
               "fw", "bw")
def sequence_mask(lengths, max_len: int):
    """[B] -> [B, max_len] float mask of t < length."""
    t = torch.arange(max_len, device=lengths.device)[None, :]
    return (t < lengths[:, None]).float()


def masked_mse(targets, outputs, lengths):
    """MaskedMSE (modules.py:532-551)."""
    mask = sequence_mask(lengths, targets.shape[1])[:, :, None].expand_as(
        targets)
    se = (targets - outputs) ** 2 * mask
    return se.sum() / dist.global_count(mask.sum()).clamp(min=1.0)


def masked_stop_ce(targets, logits, lengths, pos_weight: float = 1.0):
    """MaskedSigmoidCrossEntropy (modules.py:553-575): weighted BCE on
    logits, averaged over the nonzero in-mask positions."""
    mask = sequence_mask(lengths, targets.shape[1])
    log_w = 1.0 + (pos_weight - 1.0) * targets
    losses = ((1.0 - targets) * logits
              + log_w * (torch.log1p(torch.exp(-logits.abs()))
                         + torch.relu(-logits)))
    masked = losses * mask
    return masked.sum() / dist.global_count(
        (masked != 0).float().sum()).clamp(min=1.0)


def stop_ce(targets, logits):
    """Unmasked sigmoid cross-entropy (the default, tacotron.py:778-779)."""
    return dist.batch_mean(torch.relu(logits) - logits * targets
                           + torch.log1p(torch.exp(-logits.abs())))


def linear_loss(targets, outputs, cfg: Config, lengths=None):
    """L1 with priority below 2 kHz (tacotron.py:781-787): half the mean
    over every bin, half over the bins below 2 kHz; with `lengths` [B] the
    frames past each length masked out of both sums and the count
    (MaskedLinearLoss, modules.py:577-605)."""
    au = cfg.audio
    n_priority = int(2000 / (au.sample_rate * 0.5) * au.num_freq)
    l1 = (targets - outputs).abs()
    if lengths is None:
        return (0.5 * dist.batch_mean(l1)
                + 0.5 * dist.batch_mean(l1[:, :, :n_priority]))
    mask = sequence_mask(lengths, targets.shape[1])[:, :, None].expand_as(
        targets)
    l1 = l1 * mask
    denom = dist.global_count(mask.sum()).clamp(min=1.0)
    return 0.5 * l1.sum() / denom + 0.5 * l1[:, :, :n_priority].sum() / denom


def softmax_ce(logits, labels):
    """Mean softmax cross-entropy against integer labels."""
    return dist.batch_mean(-F.log_softmax(logits, -1).gather(
        -1, labels.long()[:, None]))


def l2_regularization(named_params: Iterable[Tuple[str, torch.Tensor]],
                      reg_weight: float):
    """reg_weight · Σ 0.5·‖W‖² over the parameters whose flax path (lower
    case) holds none of L2_EXCLUDED."""
    total = 0.0
    for name, p in named_params:
        if not any(tok in name.lower() for tok in L2_EXCLUDED):
            total = total + 0.5 * (p.float() ** 2).sum()
    return total * reg_weight


def cossim(x, y):
    """Cosine similarity of two whole tensors (tacotron.py:1267-1276), of
    the global batch's rows in a data-parallel step."""
    xx, yy, xy = dist.batch_sum(torch.stack([
        (x ** 2).sum(), (y ** 2).sum(), (x * y).sum()])).unbind()
    xn = torch.sqrt(xx + 1e-6)
    yn = torch.sqrt(yy + 1e-6)
    return xy / xn / yn


def frobenius(x):
    """‖x‖_F over the global batch's rows."""
    if dist.active() is None:
        return torch.linalg.norm(x)
    return torch.sqrt(dist.batch_sum((x * x).sum()))


def compute_losses(out: Dict, batch: Dict, named_params, cfg: Config, *,
                   use_unpaired: bool = False, nat_gan: bool = False,
                   adv_emb_disc: bool = False, emt_only: bool = False,
                   pretrained_emb_disc_all: bool = False,
                   nat_gan_derate: float = 1.0) -> Dict[str, torch.Tensor]:
    """Every loss term and the three optimizer targets: 'loss' (the main
    optimizer's), 'loss_no_mo_up' (the refnet optimizer's: 'loss' without
    the terms on `mel_outputs_up`) and 'd_loss' (nat-GAN's
    discriminator's). `out` is `Tacotron.forward`'s dict, `batch` holds
    mel_targets, stop_token_targets, targets_lengths, emt_labels and
    spk_labels (with use_unpaired emt_up_labels and spk_up_labels) as
    tensors, `named_params` the (flax path, parameter) pairs of
    `convert.flax_named_parameters`; with `predict_linear` also
    linear_targets [B, T_out, num_freq] (which the JAX feeder does not load
    either: a caller builds them). The flags are the trainer's."""
    tc, gst, au = cfg.tacotron, cfg.gst, cfg.audio
    tgt = batch["mel_targets"]
    B = tgt.shape[0]
    B_all = dist.global_rows(B)
    if tc.mask_decoder:
        lengths = batch["targets_lengths"]
        before = masked_mse(tgt, out["decoder_output"], lengths)
        after = masked_mse(tgt, out["mel_outputs"], lengths)
        stop = masked_stop_ce(batch["stop_token_targets"],
                              out["stop_token_prediction"], lengths,
                              tc.cross_entropy_pos_weight)
    else:
        before = dist.batch_mean((tgt - out["decoder_output"]) ** 2)
        after = dist.batch_mean((tgt - out["mel_outputs"]) ** 2)
        stop = stop_ce(batch["stop_token_targets"],
                       out["stop_token_prediction"])
    reg_weight = cfg.train.tacotron_reg_weight
    if cfg.train.tacotron_scale_regularization:
        reg_weight *= (1.0 / (2 * au.max_abs_value) if au.symmetric_mels
                       else 1.0 / au.max_abs_value)
    zero = tgt.new_zeros(())
    reg = dist.once(l2_regularization(named_params, reg_weight)) + zero
    style_emt = style_spk = orthog = zero
    style_up_emt = style_up_spk = mo_up_emt = mo_up_spk = zero
    style_emt_adv = style_spk_adv = zero
    g_loss = g_loss_p = g_loss_up = d_loss = zero
    emt, spk = batch["emt_labels"], batch["spk_labels"]
    derate = tc.unpaired_loss_derate
    if pretrained_emb_disc_all and out.get("refnet_out_mel_up_emt") \
            is not None:
        mo_up_emt, mo_up_spk = (dist.once(derate * ((B_all - cossim(
            out[f"refnet_out_up_{k}"], out[f"refnet_out_mel_up_{k}"]))
            / B_all)) for k in ("emt", "spk"))
    elif out.get("style_emb_logit_emt") is not None:
        style_emt = softmax_ce(out["style_emb_logit_emt"], emt)
        if adv_emb_disc and out.get("style_emb_logit_emt_adv") is not None:
            style_emt_adv = softmax_ce(out["style_emb_logit_emt_adv"], spk)
        if not emt_only and out.get("style_emb_logit_spk") is not None:
            style_spk = softmax_ce(out["style_emb_logit_spk"], spk)
            if adv_emb_disc and out.get("style_emb_logit_spk_adv") \
                    is not None:
                style_spk_adv = softmax_ce(out["style_emb_logit_spk_adv"],
                                           emt)
    if use_unpaired and not pretrained_emb_disc_all and \
            out.get("style_emb_logit_up_emt") is not None:
        emt_up, spk_up = batch["emt_up_labels"], batch["spk_up_labels"]
        style_up_emt = softmax_ce(out["style_emb_logit_up_emt"], emt_up)
        if out.get("style_emb_logit_mel_out_up_emt") is not None:
            mo_up_emt = derate * softmax_ce(
                out["style_emb_logit_mel_out_up_emt"], emt_up)
        if not emt_only:
            style_up_spk = softmax_ce(out["style_emb_logit_up_spk"], spk_up)
            if out.get("style_emb_logit_mel_out_up_spk") is not None:
                mo_up_spk = derate * softmax_ce(
                    out["style_emb_logit_mel_out_up_spk"], spk_up)
    # orthogonality (tacotron.py:840-848); under emt_attn the optional
    # l2_spk_emb penalty 0.1·‖E_spk‖_F instead, over both passes
    # (tacotron_emt_attn.py:691-695)
    if gst.emt_attn:
        if gst.l2_spk_emb and not emt_only and \
                gst.emt_attn_type != "style_tokens" and \
                out.get("refnet_out_spk") is not None:
            orthog = 0.1 * frobenius(out["refnet_out_spk"])
            if use_unpaired and out.get("refnet_out_up_spk") is not None:
                orthog = 0.1 * (frobenius(out["refnet_out_spk"])
                                + frobenius(out["refnet_out_up_spk"]))
            orthog = dist.once(orthog)
    elif gst.use_orthog_loss and not emt_only and \
            not gst.adain and not pretrained_emb_disc_all and \
            out.get("refnet_out_spk") is not None:
        rows = dist.gather_rows
        orthog = 0.02 * torch.linalg.norm(
            rows(out["refnet_out_emt"]) @ rows(out["refnet_out_spk"]).t())
        if use_unpaired and out.get("refnet_out_up_spk") is not None:
            orthog = orthog + 0.02 * torch.linalg.norm(
                rows(out["refnet_out_up_emt"])
                @ rows(out["refnet_out_up_spk"]).t())
        orthog = dist.once(orthog)
    lin = zero
    if tc.predict_linear and out.get("linear_outputs") is not None:
        if "linear_targets" not in batch:
            raise ValueError(
                "tacotron.predict_linear trains on batch['linear_targets'] "
                "[B, T_out, num_freq], which the feeder does not load (nor "
                "does the JAX feeder): the caller builds them")
        lin = linear_loss(batch["linear_targets"], out["linear_outputs"],
                          cfg, batch["targets_lengths"] if tc.mask_decoder
                          else None)
    terms = dict(before_loss=before, after_loss=after, stop_token_loss=stop,
                 linear_loss=lin, regularization_loss=reg)
    # nat-GAN, 3 classes: real, paired, unpaired (tacotron.py:869-893)
    ng = out.get("nat_gan") or {}
    if nat_gan and ng:
        cls = lambda c: torch.full((B,), c, dtype=torch.long,
                                   device=tgt.device)
        d = {k: softmax_ce(ng[f"logits_{k}"], cls(c))
             for c, k in enumerate(("targets", "mel_p", "mel_up"))
             if f"logits_{k}" in ng}
        d_loss = sum(d.values())
        for head, labels in (("emt", "emt"), ("spk", "spk")):
            for k in d:
                lab = batch[f"{labels}_up_labels" if k == "mel_up"
                            else f"{labels}_labels"]
                d_loss = d_loss + 0.1 * softmax_ce(
                    ng[f"logits_{k}_{head}"], lab)
        g_loss_p = nat_gan_derate * softmax_ce(ng["logits_mel_p"], cls(0))
        if "logits_mel_up" in ng:
            g_loss_up = nat_gan_derate * softmax_ce(ng["logits_mel_up"],
                                                    cls(0))
        g_loss = g_loss_p + g_loss_up
        terms.update(d_loss_targ=d["targets"], d_loss_p=d["mel_p"],
                     d_loss_up=d.get("mel_up", zero))
    terms.update(
        style_emb_loss_emt=style_emt, style_emb_loss_spk=style_spk,
        style_emb_loss_emt_adv=style_emt_adv,
        style_emb_loss_spk_adv=style_spk_adv,
        style_emb_orthog_loss=orthog,
        style_emb_loss_up_emt=style_up_emt,
        style_emb_loss_up_spk=style_up_spk,
        style_emb_loss_mel_out_up_emt=mo_up_emt,
        style_emb_loss_mel_out_up_spk=mo_up_spk,
        g_loss_p=g_loss_p, g_loss_up=g_loss_up, d_loss=d_loss)
    loss_no_mo_up = (before + after + stop + reg + lin + style_emt
                     + style_spk + orthog + style_up_emt + style_up_spk
                     + g_loss + style_emt_adv + style_spk_adv)
    terms.update(loss_no_mo_up=loss_no_mo_up,
                 loss=loss_no_mo_up + mo_up_emt + mo_up_spk)
    return terms
