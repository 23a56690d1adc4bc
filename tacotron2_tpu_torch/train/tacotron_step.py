"""Tacotron train and eval steps (PyTorch).

Counterpart of tacotron2_tpu/train/tacotron_step.py for the default
trainer, `TacotronTrainer(cfg)` as scripts/train_e2e_demo_r5_tpu.py builds
it: one masked Adam over every parameter (`train/optim.py`), the loss of
`models/tacotron/losses.py`, the teacher-forcing ratio of the schedule at
the state's step, and under `tacotron.compute_dtype="bfloat16"` a bf16
compute copy of the parameters (tacotron_step.py:97-107): the forward sees
every parameter rounded to bf16, while the master parameters, the
optimizer, BatchNorm and the losses stay f32. The rounding passes the
gradient through unchanged, so the gradients stay f32 (JAX's pass through
the bf16 copy). On a CUDA device the teacher-forced decode runs the train
forward and BPTT backward kernels (`ops/tacotron_train_kernel.py:
FusedTeacherForced`), on the CPU their plain versions.

Random draws — dropout, zoneout, the scheduled-sampling coins — come from
the `torch.Generator` each step is given. `eval_step` is the natural eval
(`tacotron_natural_eval`: ratio 0, every step takes its own previous
frame) in eval mode through the eval forward's kernel. Under
`tacotron.smoothing` the decode trains by autograd through its plain
version, as the JAX trainer scans it (`models/tacotron/decoder.py:
teacher_forced_route`).

What the port refuses raises ValueError with the option's name: the
unpaired/intercross pass, nat-GAN, the adversarial heads, pretrained
discriminators, the refnet optimizer, `emt_attn`, AdaIN, `emt_only`,
`predict_linear`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from ..config import Config
from ..convert import flax_named_parameters, init_tacotron
from ..models.tacotron.losses import compute_losses
from ..models.tacotron.decoder import round_bf16
from ..models.tacotron.model import Tacotron
from .optim import (MaskedAdam, global_norm, main_update_predicate,
                    make_mask, teacher_forcing_schedule)

UNPORTED_FLAGS = ("use_unpaired", "nat_gan", "adv_emb_disc",
                  "pretrained_emb_disc", "pretrained_emb_disc_all",
                  "opt_ref_no_mo", "emt_only")
BATCH_KEYS = ("inputs", "input_lengths", "mel_targets", "stop_token_targets",
              "targets_lengths", "emt_labels", "spk_labels", "ref_mel_emt",
              "ref_mel_spk")


def check_trainable(cfg: Config, **flags) -> None:
    """Raise ValueError on a trainer flag or a config the port does not
    train."""
    for name in flags:
        if name not in UNPORTED_FLAGS:
            raise TypeError(f"unknown trainer option {name!r}")
        if flags[name]:
            raise ValueError(f"{name} training is not in the port")
    gst, tc = cfg.gst, cfg.tacotron
    for name, bad in (("gst.emt_attn", gst.emt_attn), ("gst.adain", gst.adain),
                      ("gst.use_gst=False", not gst.use_gst),
                      ("gst.se_concat=False", not gst.se_concat),
                      ("tacotron.predict_linear", tc.predict_linear),
                      (f"tacotron.prenet_layers={tuple(tc.prenet_layers)} "
                       "(two of equal width)", len(tc.prenet_layers) != 2
                       or len(set(tc.prenet_layers)) != 1)):
        if bad:
            raise ValueError(f"{name} training is not in the port")


@dataclass
class TrainState:
    """The step count, the model (master parameters and BatchNorm
    statistics) and the optimizer's state."""

    step: int
    model: Tacotron
    opt: MaskedAdam


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


class TacotronTrainer:
    """Owns the config and the step functions; the state holds the
    model."""

    def __init__(self, cfg: Config, *, device="cuda", **flags):
        check_trainable(cfg, **flags)
        self.cfg, self.device = cfg, torch.device(device)
        self.tfr_schedule = teacher_forcing_schedule(cfg)
        self.timer = None   # a StepTimer to split the step's time

    # ----------------------------------------------------------------- init

    def init_state(self, generator=None, model: Tacotron | None = None
                   ) -> TrainState:
        """A fresh model (`convert.init_tacotron`, drawn from `generator`)
        or the one given, and a fresh optimizer."""
        if model is None:
            model = init_tacotron(self.cfg, generator, self.device)
        model = model.to(self.device).requires_grad_(True)
        named = flax_named_parameters(model)
        t = self.cfg.train
        mask = make_mask([n for n, _ in named], main_update_predicate(
            False, False, t.tacotron_fine_tuning))
        return TrainState(0, model, MaskedAdam(self.cfg, [p for _, p in named],
                                               mask))

    # ------------------------------------------------------------------ fwd

    def batch_to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k in BATCH_KEYS:
            v = batch[k]
            v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            out[k] = v.to(self.device)
        return out

    def _forward(self, model, b, generator, tfr, *, train: bool,
                 decode: str = "fused"):
        args = (b["inputs"], b["input_lengths"], b["mel_targets"],
                b["ref_mel_emt"], b["ref_mel_spk"])
        kwargs = dict(teacher_forcing_ratio=tfr, generator=generator,
                      train=train, decode=decode, timer=self.timer)
        if self.cfg.tacotron.compute_dtype != "bfloat16":
            return model(*args, **kwargs)
        params = {n: round_bf16(p) for n, p in model.named_parameters()}
        return functional_call(model, params, args, kwargs)

    def _time(self, name):
        return self.timer(name) if self.timer else contextlib.nullcontext()

    # ----------------------------------------------------------------- step

    def gradients(self, state: TrainState, batch, generator=None, *,
                  decode: str = "fused"):
        """The train forward and backward of `batch` (numpy arrays or
        tensors, the feeder's keys), without the update: returns (the loss
        terms, the parameters and their gradients, in the module's order,
        and the teacher-forcing ratio). decode="autograd" takes the
        decode's backward by autograd through its plain version (the
        reference the fused route is held to). BatchNorm's running
        statistics move, as in a step."""
        b = self.batch_to_device(batch)
        tfr = float(self.tfr_schedule(state.step))
        out = self._forward(state.model, b, generator, tfr, train=True,
                            decode=decode)
        named = flax_named_parameters(state.model)
        terms = compute_losses(out, b, named, self.cfg)
        params = [p for _, p in named]
        with self._time("backward"):
            grads = torch.autograd.grad(terms["loss"], params,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return terms, params, grads, tfr

    def train_step(self, state: TrainState, batch, generator=None):
        """One optimizer step on `batch`; returns (state, metrics): every
        loss term, grad_norm (of all gradients, before clipping) and
        teacher_forcing_ratio."""
        terms, params, grads, tfr = self.gradients(state, batch, generator)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics["grad_norm"] = global_norm(grads)
        metrics["teacher_forcing_ratio"] = tfr
        with self._time("optimizer"):
            state.opt.step(params, grads)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, generator=None):
        """The eval forward (ratio 0 with `tacotron_natural_eval`, else the
        schedule's) and its loss terms; returns (outputs, terms)."""
        b = self.batch_to_device(batch)
        tfr = (0.0 if self.cfg.train.tacotron_natural_eval
               else float(self.tfr_schedule(state.step)))
        out = self._forward(state.model, b, generator, tfr, train=False)
        terms = compute_losses(out, b, flax_named_parameters(state.model),
                               self.cfg)
        return out, terms
