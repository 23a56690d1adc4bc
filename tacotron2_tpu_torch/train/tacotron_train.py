"""Tacotron training host loop.

Counterpart of tacotron2_tpu/train/tacotron_train.py: the feeder with its
prefetch thread (`feeder_kwargs`: the variant options), `TacotronTrainer`
steps (`trainer_kwargs`: the trainer's flags), with nat-GAN the
discriminator's pretraining at step 0 (`nat_gan_pretrain_steps`, or
`nat_gan_pretrain_steps_unpaired` with the unpaired pass; :113-128),
rolling loss windows and the per-step log line, the loss-explosion abort
(NaN or > 100), checkpoints every `checkpoint_interval` steps (and at step
300 and the last), and every `eval_interval` steps the held-out losses
and an eval synthesis of the reference's sentences (wavs under
eval-dir/step_<step//500>/wavs, alignment and mel plots under its plots/
where matplotlib imports), each eval path behind an `EvalFailureGuard`.
A restore keeps the fresh `pretrained` parameters (JAX :73-77); then
`pretrained_disc_emt/_spk` graft a discriminator's encoder and its
BatchNorm statistics into `pretrained_ref_enc_{emt,spk}` (:81-108), from
a port disc checkpoint directory (`disc/train.py`) or a reference TF
checkpoint (`disc/tf_import.py`). The scalars go to <log_dir>/
metrics.jsonl every `summary_interval` steps ("tacotron/" and, at evals,
"eval/"; `utils/summary.py`), `profile_start`/`profile_end` trace the
steps between them with torch.profiler, and `save_output_vars` dumps the
eval forward's tensors of the first step's and each eval step's batch as
CSVs under <log_dir>/output_vars/ (:199-230). The curve goes to
<log_dir>/taco_curve.jsonl, one JSON object per logged step, as
scripts/train_e2e_demo_r5_tpu.py writes its taco_curve.jsonl: step, loss,
tfr, elapsed_s, and at eval steps the held-out loss, `held_mel_mae` and
`held_tf_diag`.

Under a data-parallel group (`parallel.dist.maybe_initialize_distributed`,
e.g. `torchrun --nproc_per_node N -m tacotron2_tpu_torch.cli train`) each
rank runs this loop on its device: its feeder takes its stride shard of
the train split and builds batches of batch_size / world rows, the
trainer steps on the global batch of batch_size rows (`dp=`), every rank
restores from the same checkpoint, the held-out losses are the global
batch's over the replicated test split (each rank its rows of each test
batch), and rank 0 alone writes checkpoints, summaries, the curve, plots,
output vars and the eval synthesis.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..convert import tacotron_to_flax
from ..data.audio import save_wav
from ..data.feeder import TacotronFeeder
from ..eval.convergence import alignment_diagonality, masked_mel_mae
from ..parallel import dist
from ..utils import ValueWindow, log
from ..utils.plot import plot_alignment, plot_spectrogram
from ..utils.summary import ProfilerHook, SummaryWriter
from .checkpoint import CheckpointManager, graft_pretrained
from .eval_guard import EvalFailureGuard
from .tacotron_step import TacotronTrainer

LOSS_WINDOWS = ("loss", "before_loss", "after_loss", "stop_token_loss",
                "regularization_loss", "style_emb_loss_emt",
                "style_emb_loss_spk", "style_emb_orthog_loss",
                "style_emb_loss_emt_adv", "style_emb_loss_spk_adv",
                "style_emb_loss_up_emt", "style_emb_loss_up_spk",
                "style_emb_loss_mel_out_up_emt",
                "style_emb_loss_mel_out_up_spk", "d_loss", "g_loss_p",
                "g_loss_up", "linear_loss")
# the variants' windows in the log line, when a flag makes them move
VARIANT_LOG = {"adv_emb_disc": ("style_emb_loss_emt_adv",),
               "use_unpaired": ("style_emb_loss_up_emt",
                                "style_emb_loss_mel_out_up_emt"),
               "nat_gan": ("d_loss", "g_loss_p", "g_loss_up")}


def tacotron_train(cfg: Config, input_path: str, log_dir: str, *,
                   train_steps: Optional[int] = None, restore: bool = False,
                   batch_size: Optional[int] = None, device="cuda",
                   checkpoint_interval: Optional[int] = None,
                   eval_interval: Optional[int] = None,
                   pad_text_multiple: int = 16, pad_mel_multiple: int = 128,
                   eval_sentences=None, feeder_kwargs: Optional[dict] = None,
                   trainer_kwargs: Optional[dict] = None,
                   pretrained_disc_emt: Optional[str] = None,
                   pretrained_disc_spk: Optional[str] = None,
                   profile_start: Optional[int] = None,
                   profile_end: Optional[int] = None,
                   save_output_vars: bool = False):
    """Train the spectrogram predictor from the train.txt at `input_path`;
    returns (checkpoint directory, final TrainState)."""
    t = cfg.train
    steps = train_steps or t.tacotron_train_steps
    ckpt_interval = checkpoint_interval or t.checkpoint_interval
    eval_interval = t.eval_interval if eval_interval is None else eval_interval
    bs = batch_size or t.tacotron_batch_size
    ckpt_dir = os.path.join(log_dir, "taco_pretrained")
    eval_dir = os.path.join(log_dir, "eval-dir")
    dp, device, local_bs = dist.host_rows(bs, device)
    chief = dist.is_chief()
    if chief:
        os.makedirs(eval_dir, exist_ok=True)
    if dp is not None:
        log(f"Data parallel: rank {dp.rank} of {dp.world} on {device}, "
            f"{local_bs} of the {bs} rows of each step")

    trainer = TacotronTrainer(cfg, device=device, dp=dp,
                              **(trainer_kwargs or {}))
    feeder = TacotronFeeder(cfg, input_path,
                            pad_text_multiple=pad_text_multiple,
                            pad_mel_multiple=pad_mel_multiple,
                            **(feeder_kwargs or {}))
    batches = feeder.prefetch(feeder.train_batches(local_bs), depth=8)
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
    for kind, path in (("emt", pretrained_disc_emt),
                       ("spk", pretrained_disc_spk)):
        if path:
            src = import_pretrained_disc(state.model, kind, path)
            log(f"Imported pretrained {kind} discriminator ({src}) from "
                f"{path}")

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
    summary = SummaryWriter(log_dir) if chief else None
    profiler = (ProfilerHook(log_dir, profile_start, profile_end) if chief
                else ProfilerHook(log_dir))
    start_step, t_start = state.step, time.time()
    curve = (open(os.path.join(log_dir, "taco_curve.jsonl"), "a",
                  encoding="utf-8") if chief else None)
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
            profiler.step(step)
            if chief and step % t.summary_interval == 0:
                summary.scalars(step, {k: float(v) for k, v in
                                       metrics.items() if np.ndim(v) == 0},
                                prefix="tacotron/")
                summary.scalars(step, {"sec_per_step": time_window.average},
                                prefix="tacotron/")
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
                              if trainer.flags[flag] for k in keys)
                    + (f", linear={windows['linear_loss'].average:.5f}"
                       if cfg.tacotron.predict_linear else "") + "]")
            if math.isnan(loss) or loss > 100.0:
                log(f"Loss exploded to {loss:.5f} at step {step}",
                    slack=True)
                raise RuntimeError(f"Loss exploded to {loss} at step {step}")
            if chief and ((ckpt_interval > 0 and step % ckpt_interval == 0)
                          or step == 300 or step == steps):
                mgr.save(step, state)
                log(f"Saved checkpoint at step {step}")
            do_eval = eval_interval and step % eval_interval == 0
            if do_eval and step > start_step:
                rec.update(_eval_losses(trainer, state, feeder, bs, step,
                                        loss_guard, summary))
                if chief:
                    _eval_synthesis(cfg, state, first, eval_dir, step,
                                    eval_sentences, synth_guard, trainer)
            if save_output_vars and (step == start_step + 1 or do_eval):
                _save_output_vars(trainer, state, batch,
                                  os.path.join(log_dir, "output_vars"), step)
            if chief:
                curve.write(json.dumps(rec) + "\n")
                curve.flush()
    finally:
        if chief:
            curve.close()
            summary.close()
        profiler.close()
    if chief and mgr.latest_step() != state.step:
        mgr.save(state.step, state)
    log(f"Tacotron training complete at step {state.step}", slack=True)
    return ckpt_dir, state


def import_pretrained_disc(model, kind: str, path: str) -> str:
    """Graft the discriminator checkpoint at `path` (a TF checkpoint or a
    port disc checkpoint directory) into the model's
    `pretrained_ref_enc_<kind>`; returns the source kind ("TF" or
    "msgpack"). KeyError where the model has no such subtree."""
    from ..disc.tf_import import is_tf_checkpoint, load_tf_disc_checkpoint
    if is_tf_checkpoint(path):
        loaded, src = load_tf_disc_checkpoint(path), "TF"
    else:
        from ..disc.train import load_pretrained_disc
        loaded, src = load_pretrained_disc(path), "msgpack"
    graft_pretrained(model, loaded["params"], loaded["batch_stats"],
                     f"pretrained_ref_enc_{kind}")
    return src


def _save_output_vars(trainer, state, batch, out_dir, step):
    """CSV dumps of the eval forward's tensors on `batch` (reference
    --save_output_vars, code/train.py:140, tacotron/train.py:446-449):
    <name>-<step>.csv, "%.6g", for the first row's mels, decoder output,
    alignments and targets, and every row's stop logits, inputs and
    lengths. A failure is logged and never stops training. Under a
    data-parallel group every rank runs the eval forward on its rows and
    rank 0 writes its own."""
    try:
        gen = torch.Generator(device=trainer.device).manual_seed(0)
        out, _ = trainer.eval_step(state, batch, gen)
        if not dist.is_chief():
            return
        os.makedirs(out_dir, exist_ok=True)
        f = lambda x: x.detach().float().cpu().numpy()
        dumps = {
            "mels": f(out["mel_outputs"])[0],
            "dec_out": f(out["decoder_output"])[0],
            "stop": f(out["stop_token_prediction"]),
            "align": f(out["alignments"])[0],
            "inp": np.asarray(batch["inputs"]),
            "inp_len": np.asarray(batch["input_lengths"])[:, None],
            "targ": np.asarray(batch["mel_targets"])[0],
        }
        if "target_lengths" in batch:
            dumps["targ_len"] = np.asarray(batch["target_lengths"])[:, None]
        if "stop_token_targets" in batch:
            dumps["stop_targ"] = np.asarray(batch["stop_token_targets"])
        if out.get("refnet_out_emt") is not None:
            dumps["emb"] = f(out["refnet_out_emt"])
        for name, arr in dumps.items():
            np.savetxt(os.path.join(out_dir, f"{name}-{step}.csv"),
                       np.asarray(arr, np.float32).reshape(arr.shape[0], -1),
                       delimiter=",", fmt="%.6g")
        log(f"Dumped output vars for step {step} -> {out_dir}")
    except Exception as e:  # a debug dump must never kill training
        log(f"save_output_vars failed at step {step}: {e}")


def _eval_losses(trainer, state, feeder, batch_size, step, guard,
                 summary=None, max_batches: int = 4) -> dict:
    """Losses, mel MAE and alignment diagonality of the natural eval on the
    held-out split (reference eval model scalars, tacotron/train.py:
    92-102, 602-650), the mean of each scalar term to `summary` under
    "eval/"; {} when there is no held-out batch. Under a data-parallel
    group each rank runs its rows of each test batch (of a multiple of the
    world's rows) and the values are the whole batch's."""
    dp = trainer.dp
    world = dp.world if dp is not None else 1
    try:
        eval_bs = min(batch_size, max(1, len(feeder.test_meta)))
        eval_bs -= eval_bs % world
        batches = feeder.test_batches(eval_bs)[:max_batches] \
            if eval_bs else []
        if not batches:
            return {}
        gen = torch.Generator(device=trainer.device).manual_seed(0)
        acc = {"loss": [], "held_mel_mae": [], "held_tf_diag": []}
        terms_acc = {}
        r = trainer.cfg.tacotron.outputs_per_step
        for b in batches:
            lb = b if dp is None else dist.shard_batch(b, dp)
            out, terms = trainer.eval_step(state, lb, gen)
            mel, align = out["mel_outputs"], out["alignments"]
            if dp is not None:
                mel = dist.all_gather_rows(mel, dp)
                align = dist.all_gather_rows(align, dp)
            for k, v in terms.items():
                if np.ndim(v) == 0:
                    terms_acc.setdefault(k, []).append(float(v))
            acc["loss"].append(float(terms["loss"]))
            acc["held_mel_mae"].append(masked_mel_mae(
                mel.float().cpu().numpy(), b))
            acc["held_tf_diag"].append(float(np.mean(alignment_diagonality(
                align.float().cpu().numpy(), b["input_lengths"],
                b["targets_lengths"], r))))
        means = {k: round(float(np.mean(v)), 4) for k, v in acc.items()}
        if summary is not None:
            summary.scalars(step, {k: float(np.mean(v))
                                   for k, v in terms_acc.items()},
                            prefix="eval/")
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
    under eval-dir/step_<step//500>/wavs and their alignment and mel plots
    under its plots/ (reference tacotron/train.py:602-706), the reference
    mels cycled from a train batch."""
    from ..data.eval_sentences import EVAL_SENTENCES
    from ..synth.tacotron_synth import TacotronSynthesizer
    bucket = os.path.join(eval_dir, f"step_{step // 500}", "wavs")
    plots = os.path.join(eval_dir, f"step_{step // 500}", "plots")
    os.makedirs(bucket, exist_ok=True)
    os.makedirs(plots, exist_ok=True)
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
            title = f"step {step} | {texts[i][:40]}"
            plot_alignment(result["alignments"][i], os.path.join(
                plots, f"step-{step}-align-{i}.png"), title=title)
            plot_spectrogram(result["mels"][i], os.path.join(
                plots, f"step-{step}-mel-{i}.png"), title=title)
        log(f"Eval synthesis wavs written for step {step} "
            f"({len(texts)} sentences)")
        guard.success()
    except Exception as e:  # a transient failure must not kill training
        guard.failure(step, e, log=log)
