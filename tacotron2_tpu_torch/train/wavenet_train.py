"""WaveNet training host loop.

Counterpart of tacotron2_tpu/train/wavenet_train.py (:30-124): the feeder
(`data/wavenet_feeder.py`), `WaveNetTrainer` steps with the EMA shadow,
rolling loss and time windows and the per-step log line, the
loss-explosion abort (NaN or > 100), checkpoints under
<log_dir>/wave_pretrained/ every `checkpoint_interval` steps and at the
last (params, EMA, optimizer, step: `train/checkpoint.py`), and every
`eval_interval` steps `_eval_losses` (:150: the EMA weights on the
held-out split) and `_eval_generation` (:174: the EMA weights through
`WaveNetSynthesizer`, which runs the sampler kernel on the card, on the
first batch's first mel; the wav, its wave plot and the plot of its
mel's reconstruction against the input mel land in <log_dir>/wave_eval/,
the plots where matplotlib imports), each behind an `EvalFailureGuard`.
The scalars go to <log_dir>/metrics.jsonl every `summary_interval` steps
("wavenet/", and "eval/" at evals; `utils/summary.py`), and
`profile_start`/`profile_end` trace the steps between them with
torch.profiler (JAX :79-80). At each checkpoint a model with a speaker
table (gin_channels > 0, `use_speaker_embedding`, and a first batch that
carries "g") writes it for the embedding projector,
`_export_speaker_embeddings` (:127-147): <log_dir>/speaker_embeddings/
embeddings.tsv and metadata.tsv; without one it writes nothing, as in
JAX. The curve goes to <log_dir>/wavenet_curve.jsonl, one JSON object a step:
step, loss, grad_norm, elapsed_s, and at eval steps eval_loss.

Under a data-parallel group (`parallel.dist`) each rank runs this loop on
its device with its stride shard of the train split in batches of
batch_size / world rows, and the trainer steps on the global batch
(`WaveNetTrainer(dp=)`); every rank restores from the same checkpoint,
the held-out loss is the global batch's over the replicated test split,
and rank 0 alone writes checkpoints, summaries, the curve, the speaker
export and the eval generation. (The JAX loop builds no mesh: under
several processes each of its processes steps alone.)
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
from ..convert import wavenet_to_flax
from ..data.audio import mel_spectrogram, preemphasis, save_wav
from ..data.wavenet_feeder import WaveNetFeeder
from ..parallel import dist
from ..utils import ValueWindow, log
from ..utils.plot import plot_spectrogram, waveplot
from ..utils.summary import ProfilerHook, SummaryWriter
from .checkpoint import CheckpointManager
from .eval_guard import EvalFailureGuard
from .wavenet_step import WaveNetTrainer


def wavenet_train(cfg: Config, input_path: str, log_dir: str, *,
                  train_steps: Optional[int] = None, restore: bool = False,
                  gta: bool = True, batch_size: Optional[int] = None,
                  device="cuda", checkpoint_interval: Optional[int] = None,
                  eval_interval: Optional[int] = None,
                  profile_start: Optional[int] = None,
                  profile_end: Optional[int] = None):
    """Train the vocoder on the (audio, mel) pairs of the map.txt or
    train.txt at `input_path`; returns (checkpoint directory, final
    WaveNetTrainState)."""
    t = cfg.train
    steps = train_steps or t.wavenet_train_steps
    ckpt_interval = checkpoint_interval or t.checkpoint_interval
    eval_interval = t.eval_interval if eval_interval is None else eval_interval
    bs = batch_size or t.wavenet_batch_size
    ckpt_dir = os.path.join(log_dir, "wave_pretrained")
    eval_dir = os.path.join(log_dir, "wave_eval")
    dp, device, local_bs = dist.host_rows(bs, device)
    chief = dist.is_chief()
    if chief:
        os.makedirs(eval_dir, exist_ok=True)
    if dp is not None:
        log(f"Data parallel: rank {dp.rank} of {dp.world} on {device}, "
            f"{local_bs} of the {bs} rows of each step")

    feeder = WaveNetFeeder(cfg, input_path, gta=gta)
    batches = iter(feeder.train_batches(local_bs))
    trainer = WaveNetTrainer(cfg, device=device, dp=dp)
    try:
        first = next(batches)
    except (IOError, FileNotFoundError) as e:
        raise RuntimeError(
            f"WaveNet feeder could not load its first batch ({e}): vocoder "
            "training needs the audio .npy beside each mel") from e
    mgr = CheckpointManager(ckpt_dir, t.max_checkpoints_to_keep)
    will_restore = restore and mgr.latest_step() is not None
    state = trainer.init_state(
        torch.Generator().manual_seed(t.wavenet_random_seed), first,
        skip_data_dependent_init=will_restore)
    n_params = sum(p.numel() for p in state.model.parameters())
    rf = cfg.wavenet.receptive_field
    log(f"Initialized WaveNet model. Receptive field {rf} samples "
        f"({rf / cfg.audio.sample_rate * 1000:.1f} ms). WaveNet Parameters "
        f"{n_params / 1e6:.3f} Million.")
    if will_restore:
        state = mgr.restore(state)
        log(f"Restored checkpoint at step {state.step}")

    loss_window, time_window = ValueWindow(100), ValueWindow(100)
    loss_guard = EvalFailureGuard("wavenet eval losses")
    gen_guard = EvalFailureGuard("wavenet eval generation")
    gen = torch.Generator().manual_seed(t.wavenet_random_seed + 1)
    summary = SummaryWriter(log_dir) if chief else None
    profiler = (ProfilerHook(log_dir, profile_start, profile_end) if chief
                else ProfilerHook(log_dir))
    t_start = time.time()
    curve = (open(os.path.join(log_dir, "wavenet_curve.jsonl"), "a",
                  encoding="utf-8") if chief else None)
    try:
        for batch in batches:
            if state.step >= steps:
                break
            t0 = time.time()
            state, metrics = trainer.train_step(state, batch, gen)
            loss = float(metrics["loss"])
            time_window.append(time.time() - t0)
            loss_window.append(loss)
            step = state.step
            profiler.step(step)
            if chief and step % t.summary_interval == 0:
                summary.scalars(step, {k: float(v) for k, v in
                                       metrics.items() if np.ndim(v) == 0},
                                prefix="wavenet/")
                summary.scalars(step, {"sec_per_step": time_window.average},
                                prefix="wavenet/")
            rec = dict(step=step, loss=round(loss, 5),
                       grad_norm=round(float(metrics["grad_norm"]), 4),
                       elapsed_s=round(time.time() - t_start, 1))
            if step % 10 == 0 or step < 5:
                log(f"Step {step:7d} [{time_window.average:.3f} sec/step, "
                    f"loss={loss:.5f}, avg_loss={loss_window.average:.5f}]")
            if math.isnan(loss) or loss > 100.0:
                log(f"Loss exploded to {loss:.5f} at step {step}",
                    slack=True)
                raise RuntimeError(f"Loss exploded to {loss} at step {step}")
            if chief and ((ckpt_interval > 0 and step % ckpt_interval == 0)
                          or step == steps):
                mgr.save(step, state)
                log(f"Saved checkpoint at step {step} (params + EMA shadow)")
                _export_speaker_embeddings(cfg, state, log_dir)
            if eval_interval and step % eval_interval == 0:
                rec.update(_eval_losses(trainer, state, feeder, bs, step,
                                        loss_guard, summary))
                if chief:
                    _eval_generation(cfg, state, first, eval_dir, step,
                                     gen_guard, trainer.device)
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
    log(f"WaveNet training complete at step {state.step}", slack=True)
    return ckpt_dir, state


def _export_speaker_embeddings(cfg, state, log_dir):
    """The speaker table of the trained weights in the embedding
    projector's TSV layout (reference wavenet_vocoder/train.py:26-39,
    327-334): embeddings.tsv, one tab-separated row a speaker, and
    metadata.tsv, one label a row; nothing without the table."""
    wn = cfg.wavenet
    table = state.model.gc_embedding
    if wn.gin_channels <= 0 or not wn.use_speaker_embedding or table is None:
        return
    emb_dir = os.path.join(log_dir, "speaker_embeddings")
    os.makedirs(emb_dir, exist_ok=True)
    arr = table.detach().float().cpu().numpy()
    with open(os.path.join(emb_dir, "embeddings.tsv"), "w") as f:
        for row in arr:
            f.write("\t".join(f"{x:.6f}" for x in row) + "\n")
    with open(os.path.join(emb_dir, "metadata.tsv"), "w") as f:
        f.write("\n".join(f"speaker_{i}" for i in range(len(arr))) + "\n")
    log(f"Speaker embedding projector export updated ({arr.shape})")


def _eval_losses(trainer, state, feeder, batch_size, step, guard,
                 summary=None, max_batches: int = 2) -> dict:
    """The EMA weights' loss on the held-out split (reference wavenet eval
    scalars, train.py:41-64), to `summary` as "eval/loss"; {} when there
    is no held-out batch. Under a data-parallel group each rank runs its
    rows of each test batch (of a multiple of the world's rows), and the
    loss is the whole batch's."""
    dp = trainer.dp
    world = dp.world if dp is not None else 1
    try:
        eval_bs = min(batch_size, max(1, len(feeder.test_meta)))
        eval_bs -= eval_bs % world
        batches = feeder.test_batches(eval_bs)[:max_batches] \
            if eval_bs else []
        if not batches:
            return {}
        rows = (lambda b: b) if dp is None else (
            lambda b: dist.shard_batch(b, dp))
        loss = float(np.mean([float(trainer.eval_step(
            state, rows(b))[1]["loss"]) for b in batches]))
        if summary is not None:
            summary.scalars(step, {"loss": loss}, prefix="eval/")
        log(f"Eval step {step}: loss={loss:.5f}")
        guard.success()
        return {"eval_loss": round(loss, 5)}
    except Exception as e:  # a transient failure must not kill training
        guard.failure(step, e, log=log)
        return {}


def _eval_generation(cfg, state, batch, eval_dir, step, guard, device):
    """Vocode the first batch's first mel with the EMA weights
    (train.py:89-126) into wave_eval/step-<step>-pred.wav, with its wave
    plot against the target and the plot of the wav's mel (preemphasised,
    rescaled by its peak as the preprocessing does) against the input.
    An unconditioned model cannot vocode a mel: its synthesizer raises
    where the JAX one does, and the guard counts the failure."""
    from ..synth.wavenet_synth import WaveNetSynthesizer
    try:
        t0 = time.time()
        hop = cfg.audio.effective_hop
        frames = max(4, int(batch["input_lengths"][0]) // hop)
        mel01 = np.asarray(batch["c"][0][:frames])
        # undo the [0, 1] rescale: the synthesizer applies it again
        lo = -cfg.audio.max_abs_value if cfg.audio.symmetric_mels else 0.0
        mel = mel01 * (cfg.audio.max_abs_value - lo) + lo
        synth = WaveNetSynthesizer(cfg, wavenet_to_flax(state.ema),
                                   device=device)
        wav = synth.synthesize([mel])[0]
        rate = len(wav) / hop / max(time.time() - t0, 1e-9)
        log(f"eval generation: {len(wav)} samples, {rate:.1f} frames/sec")
        save_wav(wav, os.path.join(eval_dir, f"step-{step}-pred.wav"),
                 cfg.audio.sample_rate)
        target = np.asarray(batch["y"][0][:len(wav)])
        waveplot(os.path.join(eval_dir, f"step-{step}-waveplot.png"), wav,
                 target, cfg.audio.sample_rate)
        a = cfg.audio
        pre = preemphasis(wav, a.preemphasis, a.preemphasize)
        if a.rescale:
            pre = pre / max(np.abs(pre).max(), 1e-9) * a.rescaling_max
        mel_rec = mel_spectrogram(pre, a)
        n = min(len(mel_rec), len(mel))
        plot_spectrogram(mel_rec[:n], os.path.join(
            eval_dir, f"step-{step}-mel-comparison.png"),
            target_spectrogram=mel[:n], title=f"step {step} reconstruction")
        guard.success()
    except Exception as e:  # a transient failure must not kill training
        guard.failure(step, e, log=log)
