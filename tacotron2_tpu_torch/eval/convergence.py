"""Convergence measures of Tacotron training.

Counterpart of tacotron2_tpu/eval/convergence.py: `batch_from_rows` (one
training batch from train.txt rows, feeder padding: inputs 0, targets
-max_abs_value, stop targets 1), `masked_mel_mae` (the mean over rows of
each row's mel MAE within its length) and `alignment_diagonality` (the
Pearson correlation of the attention's expected input position per
decoder step with the linear text-to-frame ramp); and `overfit` (:95),
the overfit-one-batch harness: train on one batch, evaluate (the natural
eval's mel MAE and diagonality) at step 1, every `eval_every` steps and
the last, stop early once both `stop_diag` and `stop_mae` are met, and
return JAX's report keys and history tuples (step, loss, mel MAE, mean
diagonality). The JAX harness starts from PRNGKey(seed); the port's from
`init_tacotron` with a `torch.Generator` seeded so, or from `model`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..config import Config
from ..text import text_to_sequence


def batch_from_rows(rows: Sequence[Sequence[str]], mel_dir: str, cfg: Config,
                    pad_text_to: int = 0, pad_mel_to: int = 0) -> Dict:
    """train.txt rows (split on '|') -> one batch of numpy arrays; the
    reference mels are the targets' first 128 frames."""
    r = cfg.tacotron.outputs_per_step
    pad_val = -cfg.audio.max_abs_value
    seqs = [np.asarray(text_to_sequence(row[7], cfg.data.cleaners), np.int32)
            for row in rows]
    mels = [np.load(os.path.join(mel_dir, row[2])) for row in rows]
    in_len = np.asarray([len(s) for s in seqs], np.int32)
    T_in = max(pad_text_to, int(in_len.max()))
    tgt_len = np.asarray([len(m) for m in mels], np.int32)
    T_out = max(pad_mel_to, int(tgt_len.max()))
    T_out = ((T_out + r - 1) // r) * r
    B = len(rows)
    inputs = np.zeros((B, T_in), np.int32)
    targets = np.full((B, T_out, cfg.audio.num_mels), pad_val, np.float32)
    stops = np.ones((B, T_out), np.float32)
    for i, (s, m) in enumerate(zip(seqs, mels)):
        inputs[i, :len(s)] = s
        targets[i, :len(m)] = m
        stops[i, :len(m) - 1] = 0.0
    refs = targets[:, :128]
    return dict(inputs=inputs, input_lengths=in_len, mel_targets=targets,
                stop_token_targets=stops, targets_lengths=tgt_len,
                ref_mel_emt=refs, ref_mel_spk=refs.copy(),
                emt_labels=np.zeros((B,), np.int32),
                spk_labels=np.zeros((B,), np.int32))


def alignment_diagonality(aligns, input_lengths, target_lengths,
                          r: int) -> List[float]:
    """Per row: Pearson correlation of the expected input position per
    decoder step with the ideal linear ramp (1.0: a monotonic diagonal)."""
    aligns = np.asarray(aligns)
    out = []
    for b in range(aligns.shape[0]):
        L = int(input_lengths[b])
        S = max(2, int(target_lengths[b]) // r)
        a = np.asarray(aligns[b, :L, :S], np.float64)
        a = a / np.maximum(a.sum(axis=0, keepdims=True), 1e-8)
        pos = (np.arange(L)[:, None] * a).sum(axis=0)
        c = np.corrcoef(pos, np.linspace(0, L - 1, S))[0, 1]
        out.append(float(0.0 if np.isnan(c) else c))
    return out


def masked_mel_mae(mel_out, batch: Dict) -> float:
    """Mean over rows of |mel - target| within each row's target length."""
    tgt = np.asarray(batch["mel_targets"])
    lens = np.asarray(batch["targets_lengths"])
    mel_out = np.asarray(mel_out)
    return float(np.mean([np.abs(mel_out[b, :int(n)] - tgt[b, :int(n)]).mean()
                          for b, n in enumerate(lens)]))


def overfit(cfg: Config, batch: Dict, steps: int, *, seed: int = 0,
            eval_every: int = 50, stop_diag: float = None,
            stop_mae: float = None, return_state: bool = False,
            device="cuda", model=None):
    """Train on one batch for `steps`; returns (report, history), or
    (report, history, the trained TrainState) with `return_state`."""
    import torch

    from ..train.tacotron_step import TacotronTrainer

    trainer = TacotronTrainer(cfg, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(seed),
                               model=model)
    gen = torch.Generator(device=trainer.device).manual_seed(seed + 1)
    r = cfg.tacotron.outputs_per_step
    history = []

    def evaluate():
        g = torch.Generator(device=trainer.device).manual_seed(123)
        out, _ = trainer.eval_step(state, batch, g)
        mel = out["mel_outputs"].float().cpu().numpy()
        aligns = out["alignments"].float().cpu().numpy()
        diag = alignment_diagonality(aligns, batch["input_lengths"],
                                     batch["targets_lengths"], r)
        return masked_mel_mae(mel, batch), diag, aligns

    metrics = None
    steps_done = 0
    for i in range(steps):
        state, metrics = trainer.train_step(state, batch, gen)
        steps_done = i + 1
        if (i + 1) % eval_every == 0 or i == 0 or i == steps - 1:
            mae, diag, _ = evaluate()
            history.append((i + 1, float(metrics["loss"]), mae,
                            float(np.mean(diag))))
            if (stop_diag is not None and stop_mae is not None
                    and float(np.mean(diag)) > stop_diag
                    and mae < stop_mae):
                break
    mae, diag, aligns = evaluate()
    report = dict(final_loss=(float(metrics["loss"])
                              if metrics is not None else None),
                  final_mel_mae=mae,
                  diagonality=diag, mean_diagonality=float(np.mean(diag)),
                  steps=steps_done,
                  initial_mel_mae=history[0][2] if history else None,
                  alignments=aligns)
    if return_state:
        return report, history, state
    return report, history
