"""Tacotron training host loop.

Counterpart of tacotron2_tpu/train/tacotron_train.py: the feeder with its
prefetch thread (`feeder_kwargs`: the variant options), `TacotronTrainer`
steps (`trainer_kwargs`: the trainer's flags), with nat-GAN the
discriminator's pretraining at step 0 (`nat_gan_pretrain_steps`, or
`nat_gan_pretrain_steps_unpaired` with the unpaired pass; :113-128),
rolling loss windows and the per-step log line, the loss-explosion abort (NaN or > 100), checkpoints
every `checkpoint_interval` steps (and at step 300 and the last), and
every `eval_interval` steps the held-out losses and an eval synthesis of
the reference's sentences (wavs; the alignment and mel plots need
matplotlib and are not written), each eval path behind an
`EvalFailureGuard`. A restore keeps the fresh `pretrained` parameters
(JAX :73-77). The curve goes to <log_dir>/taco_curve.jsonl, one JSON
object per logged step, as scripts/train_e2e_demo_r5_tpu.py writes its
taco_curve.jsonl: step, loss, tfr, elapsed_s, and at eval steps the
held-out loss, `held_mel_mae` and `held_tf_diag`.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..convert import tacotron_to_flax
from ..data.audio import save_wav
from ..data.feeder import TacotronFeeder
from ..eval.convergence import alignment_diagonality, masked_mel_mae
from ..utils import log
from .checkpoint import CheckpointManager
from .eval_guard import EvalFailureGuard
from .tacotron_step import TacotronTrainer

LOSS_WINDOWS = ("loss", "before_loss", "after_loss", "stop_token_loss",
                "regularization_loss", "style_emb_loss_emt",
                "style_emb_loss_spk", "style_emb_orthog_loss",
                "style_emb_loss_emt_adv", "style_emb_loss_spk_adv",
                "style_emb_loss_up_emt", "style_emb_loss_up_spk",
                "style_emb_loss_mel_out_up_emt",
                "style_emb_loss_mel_out_up_spk", "d_loss", "g_loss_p",
                "g_loss_up")
# the variants' windows in the log line, when a flag makes them move
VARIANT_LOG = {"adv_emb_disc": ("style_emb_loss_emt_adv",),
               "use_unpaired": ("style_emb_loss_up_emt",
                                "style_emb_loss_mel_out_up_emt"),
               "nat_gan": ("d_loss", "g_loss_p", "g_loss_up")}


class ValueWindow:
    """The mean of the last `size` values."""

    def __init__(self, size: int = 100):
        self.values = deque(maxlen=size)

    def append(self, x: float) -> None:
        self.values.append(x)

    @property
    def average(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0


def tacotron_train(cfg: Config, input_path: str, log_dir: str, *,
                   train_steps: Optional[int] = None, restore: bool = False,
                   batch_size: Optional[int] = None, device="cuda",
                   checkpoint_interval: Optional[int] = None,
                   eval_interval: Optional[int] = None,
                   pad_text_multiple: int = 16, pad_mel_multiple: int = 128,
                   eval_sentences=None, feeder_kwargs: Optional[dict] = None,
                   trainer_kwargs: Optional[dict] = None):
    """Train the spectrogram predictor from the train.txt at `input_path`;
    returns (checkpoint directory, final TrainState)."""
    t = cfg.train
    steps = train_steps or t.tacotron_train_steps
    ckpt_interval = checkpoint_interval or t.checkpoint_interval
    eval_interval = t.eval_interval if eval_interval is None else eval_interval
    bs = batch_size or t.tacotron_batch_size
    ckpt_dir = os.path.join(log_dir, "taco_pretrained")
    eval_dir = os.path.join(log_dir, "eval-dir")
    os.makedirs(eval_dir, exist_ok=True)

    trainer = TacotronTrainer(cfg, device=device, **(trainer_kwargs or {}))
    feeder = TacotronFeeder(cfg, input_path,
                            pad_text_multiple=pad_text_multiple,
                            pad_mel_multiple=pad_mel_multiple,
                            **(feeder_kwargs or {}))
    batches = feeder.prefetch(feeder.train_batches(bs), depth=8)
    first = next(batches)
    state = trainer.init_state(
        torch.Generator().manual_seed(t.tacotron_random_seed))
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"Initialized Tacotron model. Tacotron Parameters "
        f"{n_params / 1e6:.3f} Million.")
    mgr = CheckpointManager(ckpt_dir, t.max_checkpoints_to_keep)
    if restore and mgr.latest_step() is not None:
        state = mgr.restore(state, keep_fresh=lambda n: "pretrained" in n)
        log(f"Restored checkpoint at step {state.step}")

    if trainer.nat_gan and state.step == 0:
        n_disc = (t.nat_gan_pretrain_steps_unpaired if trainer.use_unpaired
                  else t.nat_gan_pretrain_steps)
        if n_disc:
            log(f"Pretraining nat-GAN discriminator for {n_disc} steps")
            pre = torch.Generator(device=trainer.device)
            pre.manual_seed(t.tacotron_random_seed + 2)
            for i in range(n_disc):
                state, dm = trainer.disc_pretrain_step(state, next(batches),
                                                       pre)
                if i % 50 == 0 or i == n_disc - 1:
                    log(f"nat-GAN disc pretrain {i}: "
                        f"d_loss={float(dm['d_loss']):.5f}")

    windows = {k: ValueWindow(100) for k in LOSS_WINDOWS}
    time_window = ValueWindow(100)
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(t.tacotron_random_seed + 1)
    loss_guard = EvalFailureGuard("tacotron eval losses")
    synth_guard = EvalFailureGuard("tacotron eval synthesis")
    start_step, t_start = state.step, time.time()
    curve = open(os.path.join(log_dir, "taco_curve.jsonl"), "a",
                 encoding="utf-8")
    try:
        while state.step < steps:
            batch = next(batches)
            t0 = time.time()
            state, metrics = trainer.train_step(state, batch, gen)
            loss = float(metrics["loss"])
            time_window.append(time.time() - t0)
            for k in windows:
                if k in metrics:
                    windows[k].append(float(metrics[k]))
            step = state.step
            rec = dict(step=step, loss=round(loss, 4),
                       tfr=round(float(metrics["teacher_forcing_ratio"]), 3),
                       grad_norm=round(float(metrics["grad_norm"]), 4),
                       elapsed_s=round(time.time() - t_start, 1))
            if step % 10 == 0 or step < 5:
                log(f"Step {step:7d} [{time_window.average:.3f} sec/step, "
                    f"loss={loss:.5f}, "
                    f"avg_loss={windows['loss'].average:.5f}, "
                    f"before={windows['before_loss'].average:.5f}, "
                    f"after={windows['after_loss'].average:.5f}, "
                    f"stop={windows['stop_token_loss'].average:.5f}"
                    + "".join(f", {k}={windows[k].average:.5f}"
                              for flag, keys in VARIANT_LOG.items()
                              if trainer.flags[flag] for k in keys) + "]")
            if math.isnan(loss) or loss > 100.0:
                log(f"Loss exploded to {loss:.5f} at step {step}")
                raise RuntimeError(f"Loss exploded to {loss} at step {step}")
            if (ckpt_interval > 0 and step % ckpt_interval == 0) \
                    or step == 300 or step == steps:
                mgr.save(step, state)
                log(f"Saved checkpoint at step {step}")
            if eval_interval and step % eval_interval == 0 \
                    and step > start_step:
                rec.update(_eval_losses(trainer, state, feeder, bs, step,
                                        loss_guard))
                _eval_synthesis(cfg, state, first, eval_dir, step,
                                eval_sentences, synth_guard, trainer)
            curve.write(json.dumps(rec) + "\n")
            curve.flush()
    finally:
        curve.close()
    if mgr.latest_step() != state.step:
        mgr.save(state.step, state)
    log(f"Tacotron training complete at step {state.step}")
    return ckpt_dir, state


def _eval_losses(trainer, state, feeder, batch_size, step, guard,
                 max_batches: int = 4) -> dict:
    """Losses, mel MAE and alignment diagonality of the natural eval on the
    held-out split (reference eval model scalars, tacotron/train.py:
    92-102, 602-650); {} when there is no held-out batch."""
    try:
        eval_bs = min(batch_size, max(1, len(feeder.test_meta)))
        batches = feeder.test_batches(eval_bs)[:max_batches]
        if not batches:
            return {}
        gen = torch.Generator(device=trainer.device).manual_seed(0)
        acc = {"loss": [], "held_mel_mae": [], "held_tf_diag": []}
        r = trainer.cfg.tacotron.outputs_per_step
        for b in batches:
            out, terms = trainer.eval_step(state, b, gen)
            acc["loss"].append(float(terms["loss"]))
            acc["held_mel_mae"].append(masked_mel_mae(
                out["mel_outputs"].float().cpu().numpy(), b))
            acc["held_tf_diag"].append(float(np.mean(alignment_diagonality(
                out["alignments"].float().cpu().numpy(), b["input_lengths"],
                b["targets_lengths"], r))))
        means = {k: round(float(np.mean(v)), 4) for k, v in acc.items()}
        log(f"Eval step {step}: loss={means['loss']:.5f} "
            f"held_mel_mae={means['held_mel_mae']:.4f} "
            f"held_tf_diag={means['held_tf_diag']:.3f}")
        guard.success()
        return {"eval_loss": means["loss"],
                "held_mel_mae": means["held_mel_mae"],
                "held_tf_diag": means["held_tf_diag"]}
    except Exception as e:  # a transient failure must not kill training
        guard.failure(step, e, log=log)
        return {}


def _eval_synthesis(cfg, state, sample_batch, eval_dir, step, sentences,
                    guard, trainer):
    """Synthesize the fixed eval sentences (hparams.py:370-395) to wavs
    under eval-dir/step_<step//500>/wavs (reference tacotron/train.py:
    602-706), the reference mels cycled from a train batch."""
    from ..data.eval_sentences import EVAL_SENTENCES
    from ..synth.tacotron_synth import TacotronSynthesizer
    bucket = os.path.join(eval_dir, f"step_{step // 500}", "wavs")
    os.makedirs(bucket, exist_ok=True)
    try:
        params, stats = tacotron_to_flax(state.model)
        synth = TacotronSynthesizer(
            cfg, params, stats, device=trainer.device,
            emt_only=trainer.emt_only,
            pretrained_emb_disc_all=trainer.pretrained_emb_disc_all)
        texts = (sentences or EVAL_SENTENCES)[:max(
            1, cfg.train.eval_num_sentences)]
        re_, rs = sample_batch["ref_mel_emt"], sample_batch["ref_mel_spk"]
        refs_e = [re_[i % len(re_)] for i in range(len(texts))]
        refs_s = [rs[i % len(rs)] for i in range(len(texts))]
        result = synth.synthesize(texts, refs_e, refs_s,
                                  max_steps=min(cfg.tacotron.max_iters, 400))
        for i, w in enumerate(synth.mels_to_wavs(result["mels"])):
            save_wav(w, os.path.join(bucket, f"step-{step}-eval-{i}.wav"),
                     cfg.audio.sample_rate)
        log(f"Eval synthesis wavs written for step {step} "
            f"({len(texts)} sentences)")
        guard.success()
    except Exception as e:  # a transient failure must not kill training
        guard.failure(step, e, log=log)
