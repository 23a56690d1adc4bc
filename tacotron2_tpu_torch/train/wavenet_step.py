"""WaveNet train and eval steps with EMA shadow weights (PyTorch).

Counterpart of tacotron2_tpu/train/wavenet_step.py: `WaveNetTrainer` with
`init_state` (:35: a fresh model, the data-dependent init when weight
norm is on, the EMA starting at the init), `train_step` (:60: the loss of
`compute_wavenet_loss`, the gradients, `WaveNetAdam`, then the EMA with
the warm-up decay min(decay, (1+t)/(10+t)), t = step + 1, :85-90, and
grad_norm of the raw gradients) and `eval_step` (:97, the EMA weights by
default). Each train step draws one dropout seed from the generator it is
given; the model takes its masks from it (`models/wavenet/model.py`). On
a CUDA device with `wavenet.use_fused_train_stack` the gated stack runs
kernels 5a and 5b (`ops/wavenet_train_kernel.py`) in either compute dtype
and at any width `stack_supported` admits, for every upsample type; the
globally conditioned (a batch's "g", speaker ids or features), the
unconditioned and the kernel_size != 3 models take the layer loop, as the
JAX model does. `timer`, a
`train/tacotron_step.StepTimer`,
splits a step's time into the forward, the backward and the optimizer.

Data parallelism (`dp=`, a `parallel.dist.DataParallel`): each rank steps
on its rows of one global batch, padded first to the group's longest
rows; the loss is the rank's share of the global batch's (masked means
over the global count), the gradients are summed over the group in one
flat bucket before the optimizer, and the EMA moves alike on every rank.
The dropout seed is the step's draw plus the rank, as the JAX stack
kernels' per-shard seed is (`seed + axis_index`,
tacotron2_tpu/models/wavenet/model.py:148-150), so a data-parallel step
equals the one-process step on the global batch at dropout 0.

Tensor parallelism (`dp` of a (data × model) group, `model_world` > 1):
the rank is data shard `dp.rank` of the batch as above, and `init_state`
cuts the whole state to the process's slices over 'model'
(`parallel.partition.shard_wavenet_state`: the residual blocks' weights,
their EMA and Adam moments). The model then runs JAX's mesh branches
(`models/wavenet/model.py`), the gradients are each slice's, summed over
the data group, and Adam, value clipping and the EMA work on the slices;
the global-norm clipping and `grad_norm` take one norm, which sums the
slices' squares over the model group and counts the replicated tensors
once, the unsharded norm (`partition.sharded_global_norm`, computed in
`train_step` and handed to Adam); the replicated tensors' gradients come
from the model group's first process, so its copies stay alike.
`partition.gather_wavenet_state` makes the whole state again, on every
process, for a checkpoint.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..config import Config
from ..convert import init_wavenet, wavenet_named_parameters
from ..data.wavenet_feeder import interp_to_unit
from ..models.wavenet.model import (WaveNet, compute_wavenet_loss,
                                    data_dependent_init)
from ..ops.mulaw import is_mulaw_quantize
from ..parallel import dist, partition
from ..utils import log
from .optim import Adam, WaveNetAdam

BATCH_KEYS = ("x", "y", "c", "input_lengths")


@dataclass
class WaveNetTrainState:
    """The step count, the model (the trained weights), its EMA shadow
    (a frozen copy) and the optimizer."""

    step: int
    model: WaveNet
    ema: WaveNet
    opt: Adam


class WaveNetTrainer:
    """Owns the config and the step functions; the state holds the
    weights."""

    def __init__(self, cfg: Config, *, device="cuda",
                 dp: dist.DataParallel | None = None):
        self.cfg, self.device, self.dp = cfg, torch.device(device), dp
        self.timer = None   # a StepTimer to split the step's time

    def init_state(self, generator=None, batch: Dict[str, Any] | None = None,
                   *, model: WaveNet | None = None,
                   skip_data_dependent_init: bool = False
                   ) -> WaveNetTrainState:
        """A fresh model (`convert.init_wavenet`, drawn from `generator`)
        or the one given, with the data-dependent init on `batch` when the
        config asks for it, an EMA copy and a fresh optimizer. A fresh
        model has the speaker input where the config has gin_channels > 0
        and `batch` carries "g", as the JAX init makes it (:38-41). Under
        `dp` the init runs on the global batch (the ranks' rows gathered),
        so every rank starts from the same weights; under a (data × model)
        group the whole state is then cut to the process's slices."""
        wn = self.cfg.wavenet
        if model is None:
            b = self.batch_to_device(batch) if batch is not None else {}
            if self.dp is not None:     # the global batch's statistics
                b = {k: dist.all_gather_rows(v, self.dp)
                     for k, v in b.items()}
            model = init_wavenet(self.cfg, generator, self.device,
                                 global_conditioning="g" in b)
            if (wn.weight_normalization and wn.data_dependent_init
                    and not skip_data_dependent_init):
                log("Applying weight normalization data-dependent init "
                    "forward pass (reference wavenet train.py:287-298)")
                data_dependent_init(model, b["x"], b["c"], b.get("g"),
                                    init_scale=wn.init_scale)
        model = model.to(self.device).requires_grad_(True)
        ema = copy.deepcopy(model).requires_grad_(False)
        params = [p for _, p in wavenet_named_parameters(model)]
        state = WaveNetTrainState(0, model, ema, WaveNetAdam(self.cfg,
                                                             params))
        if self.dp is not None and self.dp.model_world > 1:
            state = partition.shard_wavenet_state(state, self.dp)
        return state

    def batch_to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's tensors on the device; its speaker input "g" (ids
        [B] or features [B, gin]) only where the config has
        gin_channels > 0 (JAX :38, :62, :100)."""
        keys = list(BATCH_KEYS)
        if self.cfg.wavenet.gin_channels > 0 and batch.get("g") is not None:
            keys.append("g")
        out = {}
        for k in keys:
            v = batch[k]
            v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            out[k] = v.to(self.device)
        if self.dp is not None:
            out = dist.pad_to_group(out, self.pad_values(), self.dp)
        return out

    def pad_values(self) -> Dict[str, Any]:
        """The feeder's pad of x, y and c (`WaveNetFeeder._pad_batch`):
        zeros, or class 127 one-hot under mulaw-quantize; the mel pad
        clipped and rescaled as the feeder rescales c."""
        cfg = self.cfg
        au = cfg.audio
        spec = -au.max_abs_value if au.symmetric_mels else 0.0
        c = interp_to_unit(spec, cfg) if au.normalize_for_wavenet else spec
        if is_mulaw_quantize(cfg.wavenet.input_type):
            x = torch.zeros(cfg.wavenet.quantize_channels)
            x[127] = 1.0
            return dict(x=x, y=127, c=c)
        return dict(x=0.0, y=0.0, c=c)

    def _time(self, name):
        return self.timer(name) if self.timer else contextlib.nullcontext()

    def _loss(self, model, b, *, train: bool, seed=None):
        y_hat, _ = model.train_forward(b["x"], b["c"], b.get("g"),
                                       train=train, seed=seed)
        return compute_wavenet_loss(y_hat, b["y"], b["input_lengths"],
                                    self.cfg)

    def gradients(self, state: WaveNetTrainState, batch, seed: int):
        """The train forward and backward of `batch` with dropout seed
        `seed`, without the update: (loss terms, parameters, gradients).
        Under `dp` the rank's dropout seed is `seed` + rank, and the terms
        and gradients are the global batch's."""
        b = self.batch_to_device(batch)
        named = wavenet_named_parameters(state.model)
        if self.dp is not None:
            seed = seed + self.dp.rank
        with self._time("forward"), dist.activate(self.dp):
            terms = self._loss(state.model, b, train=True, seed=seed)
        params = [p for _, p in named]
        with self._time("backward"):
            grads = torch.autograd.grad(terms["loss"], params,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if self.dp is not None:
            rep = None if state.model.tp is None else [
                partition.param_axis(path, p.dim()) is None
                for path, p in named]
            grads = dist.all_reduce_grads(grads, self.dp, rep)
            terms = dist.reduce_metrics(terms, self.dp)
        return terms, params, grads

    def train_step(self, state: WaveNetTrainState, batch, generator=None):
        """One optimizer and EMA step on `batch`; returns (state, metrics):
        loss and grad_norm (of the gradients before clipping)."""
        gen = generator if generator is not None else torch.Generator()
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 device=gen.device))
        terms, params, grads = self.gradients(state, batch, seed)
        metrics = {k: v.detach() for k, v in terms.items()}
        norm = partition.sharded_global_norm(state.model, grads)
        metrics["grad_norm"] = norm
        with self._time("optimizer"):
            state.opt.step(params, grads, norm)
            # in f32, as the JAX step computes it
            one = np.float32(1.0)
            t = np.float32(state.step) + one
            decay = np.minimum(np.float32(self.cfg.train.wavenet_ema_decay),
                               (one + t) / (np.float32(10.0) + t))
            keep, take = float(decay), float(one - decay)
            with torch.no_grad():
                ema = list(state.ema.parameters())
                torch._foreach_mul_(ema, keep)
                torch._foreach_add_(ema, list(state.model.parameters()),
                                    alpha=take)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: WaveNetTrainState, batch,
                  use_ema: bool = True):
        """The eval forward (no dropout) and its loss; returns (y_hat,
        terms)."""
        b = self.batch_to_device(batch)
        model = state.ema if use_ema else state.model
        y_hat, _ = model.train_forward(b["x"], b["c"], b.get("g"),
                                       train=False)
        with dist.activate(self.dp):
            terms = compute_wavenet_loss(y_hat, b["y"], b["input_lengths"],
                                         self.cfg)
        if self.dp is not None:
            terms = dist.reduce_metrics(terms, self.dp)
        return y_hat, terms
