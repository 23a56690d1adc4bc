"""Schedules, parameter masks and the Adam of the port's trainers.

Counterpart of tacotron2_tpu/train/optim.py for the default trainer:
`tacotron_lr_schedule` (tf.train.exponential_decay clipped to [final,
init]), `teacher_forcing_schedule` (constant, or 'scheduled': the narrow
exponential decay after `start_decay`), `make_mask`,
`main_update_predicate`, and the optimizers. One `Adam` writes out
optax's Adam chain as plain tensor arithmetic that follows optax's
operations; the trainers differ only in its settings:

- `MaskedAdam`, the main optimizer of `make_tacotron_optimizer`
  (:147-173): `masked_only(chain(clip_by_global_norm(1.0), adam(lr, b1,
  b2, eps)))`, the step's learning rate at the count before the update,
  no update and no moments off the mask. `tacotron_masks` gives the masks
  of the up to three optimizers: the main one (`main_update_predicate`),
  the refnet optimizer's (`is_refnet_var`, with `opt_ref_no_mo` or
  `pretrained_emb_disc_all`) and nat-GAN's (`is_nat_gan_var`), disjoint;
  each is a `MaskedAdam` of its own, whose clipping and moments see its
  masked-on gradients alone, as optax's `masked_only` does.
- `WaveNetAdam`, `make_wavenet_optimizer` (:176) with
  `wavenet_lr_schedule` (:73, exponential or noam): optax's chain in its
  order, `clip_by_global_norm(wavenet_gradient_max_norm)`,
  `clip(wavenet_gradient_max_value)` by value, then Adam with the WaveNet
  betas and eps.
- The style discriminators' `chain(clip_by_global_norm(3.0), adam(lr))`
  and plain `adam(1e-4)` (disc/train.py): `Adam(params, lr,
  max_norm=...)` with optax's default betas and eps.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..config import Config


def exponential_decay(init: float, start_decay: int, decay_steps: int,
                      decay_rate: float, lo=None, hi=None) -> Callable:
    """init · rate^((step - start) / steps), clipped to [lo, hi]."""

    def schedule(step):
        lr = init * decay_rate ** ((float(step) - start_decay) / decay_steps)
        if lo is not None:
            lr = max(lr, lo)
        if hi is not None:
            lr = min(lr, hi)
        return lr

    return schedule


def tacotron_lr_schedule(cfg: Config) -> Callable:
    t = cfg.train
    if not t.tacotron_decay_learning_rate:
        return lambda step: t.tacotron_initial_learning_rate
    return exponential_decay(
        t.tacotron_initial_learning_rate, t.tacotron_start_decay,
        t.tacotron_decay_steps, t.tacotron_decay_rate,
        lo=t.tacotron_final_learning_rate,
        hi=t.tacotron_initial_learning_rate)


def teacher_forcing_schedule(cfg: Config) -> Callable:
    """The teacher-forcing ratio as a function of the step
    (helpers.py:140-179)."""
    t = cfg.train
    if t.tacotron_teacher_forcing_mode == "constant":
        return lambda step: t.tacotron_teacher_forcing_ratio
    init = t.tacotron_teacher_forcing_init_ratio
    decay = exponential_decay(init, t.tacotron_teacher_forcing_start_decay,
                              t.tacotron_teacher_forcing_decay_steps, 0.1)

    def schedule(step):
        if step < t.tacotron_teacher_forcing_start_decay:
            return init
        return decay(step)

    return schedule


def wavenet_lr_schedule(cfg: Config) -> Callable:
    t = cfg.train
    if t.wavenet_lr_schedule == "noam":
        warmup = t.wavenet_warmup

        def schedule(step):
            step = max(float(step), 1.0)
            return (t.wavenet_learning_rate * warmup ** 0.5
                    * min(step * warmup ** -1.5, step ** -0.5))

        return schedule
    return exponential_decay(t.wavenet_learning_rate, 0,
                             t.wavenet_decay_steps, t.wavenet_decay_rate)


def is_refnet_var(name: str) -> bool:
    """The 'optimizer_r' variable set (tacotron.py:1064)."""
    return "refnet" in name or "style_disc" in name


def is_nat_gan_var(name: str) -> bool:
    return "nat_gan" in name


def is_pretrained_var(name: str) -> bool:
    return "pretrained" in name


def main_update_predicate(opt_ref_no_mo: bool, pretrained_emb_disc_all: bool,
                          fine_tuning: bool) -> Callable[[str], bool]:
    """The main optimizer's variable filter (tacotron.py:1047-1050)."""

    def pred(name: str) -> bool:
        if is_pretrained_var(name) or is_nat_gan_var(name):
            return False
        if (opt_ref_no_mo or pretrained_emb_disc_all) and is_refnet_var(name):
            return False
        if fine_tuning and ("inputs_embedding" in name or "encoder_" in name
                            or name.startswith("encoder")):
            return False
        return True

    return pred


def make_mask(names: Sequence[str], predicate) -> List[bool]:
    """predicate of each (lower-case) flax path."""
    return [bool(predicate(n.lower())) for n in names]


def tacotron_masks(names: Sequence[str], *, opt_ref_no_mo: bool = False,
                   pretrained_emb_disc_all: bool = False,
                   nat_gan: bool = False, fine_tuning: bool = False):
    """(main, refnet or None, nat-GAN or None): the masks over the flax
    paths `names` of `make_tacotron_optimizer`'s three optimizers."""
    main = make_mask(names, main_update_predicate(
        opt_ref_no_mo, pretrained_emb_disc_all, fine_tuning))
    refnet = (make_mask(names, is_refnet_var)
              if opt_ref_no_mo or pretrained_emb_disc_all else None)
    nat = make_mask(names, is_nat_gan_var) if nat_gan else None
    return main, refnet, nat


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ‖x‖²) over the tensors (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class Adam:
    """optax's `chain([clip_by_global_norm(max_norm)], [clip(max_value)],
    adam(lr, b1, b2, eps))` on a list of parameters, updated in place as
    multi-tensor (foreach) ops: the global norm, scaling by max_norm/norm
    when the norm is not below max_norm; clipping by value; moments
    (1-b)·g + b·m; bias correction by 1 - b^count; eps outside the square
    root; `lr` a constant or a schedule of the count before the update.
    Where `mask` is given the chain is `masked_only`: its clipping and
    moments see the masked-on gradients alone, and `mu`, `nu` are None off
    the mask. `count` is the updates made."""

    def __init__(self, params: Sequence[torch.Tensor], lr, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_norm: float | None = None,
                 max_value: float | None = None,
                 mask: Sequence[bool] | None = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.max_norm, self.max_value = max_norm, max_value
        self.mask = [True] * len(params) if mask is None else list(mask)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) if m else None
                   for p, m in zip(params, self.mask)]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) if m else None
                   for p, m in zip(params, self.mask)]
        self.count = 0

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        on = [i for i, m in enumerate(self.mask) if m]
        if not on:          # every tensor masked off: only the count moves
            self.count += 1
            return
        p = [params[i] for i in on]
        mu = [self.mu[i] for i in on]
        nu = [self.nu[i] for i in on]
        g = [grads[i].float() for i in on]
        if self.max_norm is not None:
            norm = float(global_norm(g))
            if norm >= self.max_norm:
                g = torch._foreach_mul(torch._foreach_div(g, norm),
                                       self.max_norm)
        if self.max_value is not None:
            g = torch._foreach_clamp_max(
                torch._foreach_clamp_min(g, -self.max_value), self.max_value)
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        torch._foreach_add_(p, upd, alpha=-lr)


def MaskedAdam(cfg: Config, params: Sequence[torch.Tensor],
               mask: Sequence[bool]) -> Adam:
    """`masked_only(chain(clip_by_global_norm(1.0), adam(...)))`: a
    Tacotron optimizer of `make_tacotron_optimizer`."""
    t = cfg.train
    return Adam(params, tacotron_lr_schedule(cfg), b1=t.tacotron_adam_beta1,
                b2=t.tacotron_adam_beta2, eps=t.tacotron_adam_epsilon,
                max_norm=1.0 if t.tacotron_clip_gradients else None,
                mask=mask)


def WaveNetAdam(cfg: Config, params: Sequence[torch.Tensor]) -> Adam:
    """`make_wavenet_optimizer`'s chain."""
    t = cfg.train
    clip = t.wavenet_clip_gradients
    return Adam(params, wavenet_lr_schedule(cfg), b1=t.wavenet_adam_beta1,
                b2=t.wavenet_adam_beta2, eps=t.wavenet_adam_epsilon,
                max_norm=t.wavenet_gradient_max_norm if clip else None,
                max_value=t.wavenet_gradient_max_value if clip else None)
