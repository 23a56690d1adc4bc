"""Tacotron train and eval steps (PyTorch).

Counterpart of tacotron2_tpu/train/tacotron_step.py: `TacotronTrainer(cfg,
**flags)` with the JAX trainer's flags — `emt_only`, `adv_emb_disc`,
`nat_gan`, `pretrained_emb_disc`, `pretrained_emb_disc_all`,
`use_unpaired`, `opt_ref_no_mo`, `nat_gan_derate` — and `gst.use_gst=False`.
Up to three masked Adams (`train/optim.py:tacotron_masks`): the main one,
the refnet optimizer's and nat-GAN's, over disjoint parameters; the loss
of `models/tacotron/losses.py`; the teacher-forcing ratio of the schedule
at the state's step; and under `tacotron.compute_dtype="bfloat16"` a bf16
compute copy of the parameters (tacotron_step.py:97-107): the forward sees
every parameter rounded to bf16, while the master parameters, the
optimizers, BatchNorm and the losses stay f32. The rounding passes the
gradient through unchanged, so the gradients stay f32 (JAX's pass through
the bf16 copy). On a CUDA device each teacher-forced decode (one a pass:
two with `use_unpaired`) runs the train forward kernel and its BPTT
backward kernel (`ops/tacotron_train_kernel.py:FusedTeacherForced`), on
the CPU their plain versions.

A train step runs one forward, then `torch.autograd.grad` once a target
over that graph: 'loss' over every parameter (its global norm is
`grad_norm`, as `optax.global_norm` takes it), 'loss_no_mo_up' over the
refnet optimizer's parameters, 'd_loss' over nat-GAN's. JAX takes the
extra gradients at the step's parameters with the same draws, i.e. of the
same forward, and optax's `masked_only` clips and adapts over the
masked-on leaves alone, so this is the JAX step exactly. Each target
whose parameters feed a decode launches that decode's backward again:
'loss' and 'loss_no_mo_up' reach both passes, 'd_loss' neither.
`disc_pretrain_step` is nat-GAN's discriminator pretraining (only its
parameters move; the step does not advance).

Random draws — dropout, zoneout, the scheduled-sampling coins — come from
the `torch.Generator` each step is given. `eval_step` is the natural eval
(`tacotron_natural_eval`: ratio 0, every step takes its own previous
frame) in eval mode through the eval forward's kernel, of the paired pass
alone: its terms are those of the JAX eval with `use_unpaired=False`
(JAX's own unpaired eval fails on test batches, which carry no crossed
references). Under `tacotron.smoothing`, `gst.emt_attn` or a prenet other
than two layers of one width the decode trains by autograd through its
plain version, on the device of the batch, as the JAX trainer scans it
(`models/tacotron/decoder.py:teacher_forced_route`); AdaIN,
`se_concat=False` and `predict_linear` (whose batches carry
`linear_targets`, built by the caller as for the JAX trainer) train
through the kernels as the default model does. The refnet optimizer
takes the parameters JAX's name predicate gives it (`refnet`,
`style_disc`): AdaIN's `reference_encoder` trains under the main one.
Under emt_attn the batch's emotion labels drive style_tokens' query, as
in the JAX step.

Data parallelism (`dp=`, a `parallel.dist.DataParallel`): each rank steps
on its rows of one global batch, and the step is the step over the
global batch, as the JAX trainer's is under a mesh
(tacotron2_tpu/train/tacotron_train.py:110-145). The batch's padded axes
are padded to their longest over the group first (the loss means of
`mask_decoder=False` and BatchNorm's statistics count the padding, as
JAX's over the global batch's); inside `dist.activate` the BatchNorms
take the global batch's statistics, the loss terms are the rank's shares
of the global ones, and the random draws of dropout and zoneout are the
rank's rows of the global batch's (the coins are alike on every rank);
after each target's backward its gradients are summed over the group,
one flat bucket a target. Clipping and the optimizers then see the same
gradients on every rank, so the parameters stay the same without a
broadcast. The metrics are the global batch's.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..config import Config
from ..convert import flax_named_parameters, init_tacotron
from ..models.tacotron.losses import compute_losses
from ..models.tacotron.decoder import round_bf16
from ..models.tacotron.model import Tacotron
from ..parallel import dist
from .optim import (Adam, MaskedAdam, global_norm, tacotron_masks,
                    teacher_forcing_schedule)

TRAINER_FLAGS = ("emt_only", "adv_emb_disc", "nat_gan",
                 "pretrained_emb_disc", "pretrained_emb_disc_all",
                 "use_unpaired", "opt_ref_no_mo", "nat_gan_derate")
# the model's keywords among them
MODEL_FLAGS = ("emt_only", "adv_emb_disc", "nat_gan", "pretrained_emb_disc",
               "pretrained_emb_disc_all", "use_unpaired")
BATCH_KEYS = ("inputs", "input_lengths", "mel_targets", "stop_token_targets",
              "targets_lengths", "emt_labels", "spk_labels", "ref_mel_emt",
              "ref_mel_spk", "linear_targets")
UP_KEYS = ("ref_mel_up_emt", "ref_mel_up_spk", "emt_up_labels",
           "spk_up_labels")


def check_trainable(cfg: Config, **flags) -> None:
    """Raise TypeError on a flag the JAX trainer does not have."""
    for name in flags:
        if name not in TRAINER_FLAGS:
            raise TypeError(f"unknown trainer option {name!r}")


@dataclass
class TrainState:
    """The step count, the model (master parameters and BatchNorm
    statistics) and the optimizers' states: the main one, and the refnet
    and nat-GAN ones where the flags ask for them."""

    step: int
    model: Tacotron
    opt: Adam
    opt_refnet: Optional[Adam] = None
    opt_nat: Optional[Adam] = None

    def optimizers(self):
        """(target, optimizer) of each optimizer the state holds."""
        return [(t, o) for t, o in (("loss", self.opt),
                                    ("loss_no_mo_up", self.opt_refnet),
                                    ("d_loss", self.opt_nat))
                if o is not None]


class StepTimer:
    """Sums of CUDA-event times (ms) of named phases; `timer(name)` is a
    context manager."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.append((name, start, end))

    def totals(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        self.events = []
        return out


# the optimizers' names in a step's StepTimer split
OPT_TIMER = {"loss": "optimizer", "loss_no_mo_up": "optimizer (refnet)",
             "d_loss": "optimizer (nat-GAN)"}


class TacotronTrainer:
    """Owns the config, the flags and the step functions; the state holds
    the model and the optimizers."""

    def __init__(self, cfg: Config, *, device="cuda",
                 dp: Optional[dist.DataParallel] = None, **flags):
        check_trainable(cfg, **flags)
        self.cfg, self.device, self.dp = cfg, torch.device(device), dp
        self.flags = {k: bool(flags.get(k, False)) for k in TRAINER_FLAGS
                      if k != "nat_gan_derate"}
        self.nat_gan_derate = float(flags.get("nat_gan_derate", 1.0))
        for k, v in self.flags.items():
            setattr(self, k, v)
        self.tfr_schedule = teacher_forcing_schedule(cfg)
        self.timer = None   # a StepTimer to split the step's time

    # ----------------------------------------------------------------- init

    def init_state(self, generator=None, model: Tacotron | None = None
                   ) -> TrainState:
        """A fresh model (`convert.init_tacotron`, drawn from `generator`)
        or the one given, and fresh optimizers."""
        mflags = {k: self.flags[k] for k in MODEL_FLAGS}
        if model is None:
            model = init_tacotron(self.cfg, generator, self.device, **mflags)
        model = model.to(self.device).requires_grad_(True)
        named = flax_named_parameters(model)
        params = [p for _, p in named]
        masks = tacotron_masks(
            [n for n, _ in named], opt_ref_no_mo=self.opt_ref_no_mo,
            pretrained_emb_disc_all=self.pretrained_emb_disc_all,
            nat_gan=self.nat_gan,
            fine_tuning=self.cfg.train.tacotron_fine_tuning)
        opts = [MaskedAdam(self.cfg, params, m) if m is not None else None
                for m in masks]
        return TrainState(0, model, *opts)

    # ------------------------------------------------------------------ fwd

    def batch_to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k in BATCH_KEYS + UP_KEYS:
            if k not in batch:
                continue
            v = batch[k]
            v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            out[k] = v.to(self.device)
        if self.dp is not None:
            out = dist.pad_to_group(out, self.pad_values(), self.dp)
        return out

    def pad_values(self) -> Dict[str, float]:
        """The feeder's pad value of each padded batch key (inputs 0, mels
        the target pad, stop tokens 1; linear targets, which callers
        build, the target pad)."""
        au = self.cfg.audio
        mel = -au.max_abs_value if au.symmetric_mels else 0.0
        return dict(inputs=0, mel_targets=mel, stop_token_targets=1.0,
                    ref_mel_emt=mel, ref_mel_spk=mel, ref_mel_up_emt=mel,
                    ref_mel_up_spk=mel, linear_targets=mel)

    def _forward(self, model, b, generator, tfr, *, train: bool,
                 decode: str = "fused", use_unpaired: bool = False):
        args = (b["inputs"], b["input_lengths"], b["mel_targets"],
                b["ref_mel_emt"], b["ref_mel_spk"], b.get("ref_mel_up_emt"),
                b.get("ref_mel_up_spk"))
        kwargs = dict(teacher_forcing_ratio=tfr, generator=generator,
                      train=train, decode=decode, timer=self.timer,
                      use_unpaired=use_unpaired,
                      emt_labels=b.get("emt_labels"))
        if self.cfg.tacotron.compute_dtype != "bfloat16":
            return model(*args, **kwargs)
        params = {n: round_bf16(p) for n, p in model.named_parameters()}
        return functional_call(model, params, args, kwargs)

    def _losses(self, out, b, model, use_unpaired: bool):
        return compute_losses(
            out, b, flax_named_parameters(model), self.cfg,
            use_unpaired=use_unpaired, nat_gan=self.nat_gan,
            adv_emb_disc=self.adv_emb_disc, emt_only=self.emt_only,
            pretrained_emb_disc_all=self.pretrained_emb_disc_all,
            nat_gan_derate=self.nat_gan_derate)

    def _time(self, name):
        return self.timer(name) if self.timer else contextlib.nullcontext()

    # ----------------------------------------------------------------- step

    def step_gradients(self, state: TrainState, batch, generator=None, *,
                       decode: str = "fused", targets=None):
        """The train forward of `batch` (numpy arrays or tensors, the
        feeder's keys) and the gradient of each target, without the
        update: returns (the loss terms, the parameters in the module's
        order, {target: gradients}, the teacher-forcing ratio). 'loss'
        has a gradient for every parameter (zero where it does not reach),
        'loss_no_mo_up' and 'd_loss' for their optimizer's masked-on ones
        (None elsewhere). `targets` defaults to those of the state's
        optimizers. decode="autograd" (or "replay": on the fused
        forward's values, `Tacotron.forward`) takes the decodes' backward by
        autograd through their plain version (the reference the fused
        route is held to). BatchNorm's running statistics move, as in a
        step. Under `dp` the gradients are the global batch's (summed over
        the group) and the terms its values, without graph."""
        b = self.batch_to_device(batch)
        tfr = float(self.tfr_schedule(state.step))
        with dist.activate(self.dp):
            out = self._forward(state.model, b, generator, tfr, train=True,
                                decode=decode, use_unpaired=self.use_unpaired)
            terms = self._losses(out, b, state.model, self.use_unpaired)
        params = [p for _, p in flax_named_parameters(state.model)]
        masks = {t: o.mask for t, o in state.optimizers()}
        targets = list(targets or masks)
        grads = {}
        with self._time("backward"):
            for i, t in enumerate(targets):
                on = [j for j, m in enumerate(masks.get(t, []))
                      if m] if t != "loss" else list(range(len(params)))
                # an optimizer may mask every tensor off (the refnet one
                # under AdaIN, whose reference_encoder the main one trains)
                got = torch.autograd.grad(
                    terms[t], [params[j] for j in on], allow_unused=True,
                    retain_graph=i < len(targets) - 1) if on else ()
                g = [None] * len(params)
                for j, x in zip(on, got):
                    g[j] = torch.zeros_like(params[j]) if x is None else x
                grads[t] = (g if self.dp is None
                            else dist.all_reduce_grads(g, self.dp))
        if self.dp is not None:
            terms = dist.reduce_metrics(terms, self.dp)
        return terms, params, grads, tfr

    def gradients(self, state: TrainState, batch, generator=None, *,
                  decode: str = "fused"):
        """`step_gradients` of 'loss' alone: (terms, parameters, the
        gradient of 'loss' for each, ratio)."""
        terms, params, grads, tfr = self.step_gradients(
            state, batch, generator, decode=decode, targets=["loss"])
        return terms, params, grads["loss"], tfr

    def train_step(self, state: TrainState, batch, generator=None):
        """One optimizer step on `batch`; returns (state, metrics): every
        loss term, grad_norm (of all of 'loss''s gradients, before
        clipping) and teacher_forcing_ratio. The optimizers update their
        disjoint parameters, each from its own target's gradients."""
        terms, params, grads, tfr = self.step_gradients(state, batch,
                                                        generator)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics["grad_norm"] = global_norm(grads["loss"])
        metrics["teacher_forcing_ratio"] = tfr
        for t, opt in state.optimizers():
            with self._time(OPT_TIMER[t]):
                opt.step(params, grads[t])
        state.step += 1
        return state, metrics

    def disc_pretrain_step(self, state: TrainState, batch, generator=None):
        """nat-GAN's discriminator alone (JAX :176-205, the reference's
        pretraining at step 0): the train forward, 'd_loss''s gradient over
        nat-GAN's parameters and their update; the step does not advance.
        Returns (state, {d_loss, g_loss_p, g_loss_up} and the 3-class
        terms d_loss_targ, d_loss_p, d_loss_up)."""
        if state.opt_nat is None:
            raise ValueError("disc pretraining needs nat_gan=True")
        terms, params, grads, _ = self.step_gradients(
            state, batch, generator, targets=["d_loss"])
        with self._time(OPT_TIMER["d_loss"]):
            state.opt_nat.step(params, grads["d_loss"])
        return state, {k: terms[k].detach() for k in (
            "d_loss", "g_loss_p", "g_loss_up", "d_loss_targ", "d_loss_p",
            "d_loss_up")}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, generator=None):
        """The eval forward (ratio 0 with `tacotron_natural_eval`, else the
        schedule's) of the paired pass and its loss terms; returns
        (outputs, terms)."""
        b = self.batch_to_device(batch)
        tfr = (0.0 if self.cfg.train.tacotron_natural_eval
               else float(self.tfr_schedule(state.step)))
        with dist.activate(self.dp):
            out = self._forward(state.model, b, generator, tfr, train=False)
            terms = self._losses(out, b, state.model, False)
        if self.dp is not None:
            terms = dist.reduce_metrics(terms, self.dp)
        return out, terms
