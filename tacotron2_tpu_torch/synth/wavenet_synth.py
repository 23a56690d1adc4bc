"""WaveNet synthesizer: mels → waveforms with the (EMA) vocoder weights.

Port of tacotron2_tpu/synth/wavenet_synth.py: `WaveNetSynthesizer` (:25)
with `_prepare_mels` (:50), `synthesize` (:64) and `synthesize_debug`
(:108), and `run_synthesis` (:143, each wav's wave plot under plots/
where matplotlib imports). The mels are
padded, clipped and rescaled to [0, 1], upsampled, and sampled through
`ops/wavenet_kernel.sample`: on a CUDA device every output head
(Gaussian, mixture of logistics, categorical) goes through the CUDA
sampler kernel, the JAX package's `use_fused_kernel=True` route
(`fused_incremental_sample`, "all output heads"), at every width the
kernel takes (`wavenet_kernel.takes_kernel`); at other widths, and on the
CPU, through its plain version, as the JAX synthesizer takes its scan.
Every upsample type is taken; a model with global conditioning is
sampled without its speaker, as in JAX; kernel_size != 3 takes the plain
sampler. The cache and weight dtypes are the config's
`wavenet.sampler_cache_dtype` / `sampler_weight_dtype`, as the JAX
synthesizer passes them to its kernel. Each call draws its noise from a
`torch.Generator` on the device, reseeded from a counter that starts at
`seed` and advances by one a call (the JAX synthesizer's `_seed_counter`).
Waveforms are trimmed to frames · hop samples and mulaw or
mulaw-quantize outputs inverted.
"""

from __future__ import annotations

import os
from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..config import Config
from ..data import audio as host_audio
from ..data.wavenet_feeder import interp_to_unit
from ..models.wavenet.distributions import (
    draw_noise, head_kind, sample_from_discretized_mix_logistic)
from ..models.wavenet.sampler import extract_sampler_params
from ..ops import wavenet_kernel as wk
from ..ops.mulaw import inv_mulaw, inv_mulaw_quantize, mulaw_quantize
from ..utils import log
from ..utils.plot import waveplot


def sampler_dtype(name: str) -> torch.dtype:
    """A `wavenet.sampler_*_dtype` config value -> the torch dtype."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class WaveNetSynthesizer:
    """WaveNet weights (a flax param tree of numpy arrays) bound for
    batched vocoding on `device`. `keep_intermediates=True` keeps the last
    call's conditioning and noise in `self.intermediates`, so a check can
    replay the kernel against its plain version on the same numbers."""

    def __init__(self, cfg: Config, ema_params, *, device="cuda",
                 seed: int = 0, keep_intermediates: bool = False):
        wn = cfg.wavenet
        self.cfg, self.device = cfg, torch.device(device)
        self.kind = head_kind(cfg)[0]
        self.model = convert.wavenet_from_flax(cfg, ema_params, device)
        self.sampler_params = extract_sampler_params(ema_params, cfg, device)
        self.cache_dtype = sampler_dtype(wn.sampler_cache_dtype)
        self.weight_dtype = sampler_dtype(wn.sampler_weight_dtype)
        self.sampler_kernel = (
            wk.pack_weights(self.sampler_params, cfg,
                            cache_dtype=self.cache_dtype,
                            weight_dtype=self.weight_dtype)
            if wk.takes_kernel(cfg, self.device, self.weight_dtype)
            else None)
        self.generator = torch.Generator(device=self.device)
        self._seed_counter = seed
        self.keep_intermediates = keep_intermediates
        self.intermediates = {}

    def _prepare_mels(self, mels: Sequence[np.ndarray]):
        a = self.cfg.audio
        pad_val = -a.max_abs_value if a.symmetric_mels else 0.0
        max_len = max(len(m) for m in mels)
        out = []
        for m in mels:
            m = np.pad(np.asarray(m, np.float32),
                       ((0, max_len - len(m)), (0, 0)),
                       constant_values=pad_val)
            if a.clip_for_wavenet:
                m = np.clip(m, pad_val, a.max_abs_value)
            if a.normalize_for_wavenet:
                m = interp_to_unit(m, self.cfg)
            out.append(m)
        return np.stack(out).astype(np.float32), [len(m) for m in mels]

    def _finish(self, samples: np.ndarray, frame_lengths) -> List[np.ndarray]:
        """Trim each row to frames · hop samples and undo the mulaw
        companding or quantization of the output."""
        wn, hop = self.cfg.wavenet, self.cfg.audio.effective_hop
        wavs = []
        for i, n in enumerate(frame_lengths):
            wav = samples[i, :n * hop]
            if wn.input_type == "mulaw-quantize":
                wav = inv_mulaw_quantize(wav.astype(np.int32),
                                         wn.quantize_channels - 1)
            elif wn.input_type == "mulaw":
                wav = inv_mulaw(wav, wn.quantize_channels - 1)
            wavs.append(np.asarray(wav, np.float32))
        return wavs

    @torch.no_grad()
    def synthesize(self, mels: Sequence[np.ndarray],
                   speaker_ids: Optional[Sequence[int]] = None
                   ) -> List[np.ndarray]:
        """Batched mels [frames, num_mels] → waveforms trimmed to their
        true lengths. `speaker_ids` is accepted and unused, as in the JAX
        synthesizer (:64-90): a model with global conditioning is sampled
        without its speaker (its kernel drops the gin weights, its scan
        gets no g_vec). An unconditioned model (cin_channels <= 0) raises
        ValueError at the upsample, where the JAX one fails with an
        AttributeError."""
        c, frame_lengths = self._prepare_mels(mels)
        c_up = self.model.upsample(torch.as_tensor(c, device=self.device))
        B, T, _ = c_up.shape
        self._seed_counter += 1
        self.generator.manual_seed(self._seed_counter)
        noise = draw_noise(self.cfg, B, T, self.generator, self.device)
        sample = (wk.sample_plain if self.sampler_kernel is None else
                  partial(wk.sample, kernel_weights=self.sampler_kernel))
        samples = sample(self.sampler_params, self.cfg, c_up, noise,
                         cache_dtype=self.cache_dtype,
                         weight_dtype=self.weight_dtype)
        if self.keep_intermediates:
            self.intermediates = dict(c_up=c_up, noise=noise)
        return self._finish(samples.cpu().numpy(), frame_lengths)

    @torch.no_grad()
    def synthesize_debug(self, wavs: Sequence[np.ndarray],
                         mels: Sequence[np.ndarray], noise=None
                         ) -> List[np.ndarray]:
        """Teacher-forced sanity path (reference `wavenet_synth_debug`):
        the parallel eval forward on ground-truth waveforms, returning the
        one-step-ahead predictions — the Gaussian mean, the categorical
        argmax (inverted), or a mixture-of-logistics draw from
        `sample_from_discretized_mix_logistic` with uniforms `noise` =
        (temp [B, T, nr], u [B, T]) in [1e-5, 1-1e-5] (drawn from a
        generator seeded 0 if not given). For mulaw-quantize the input is
        the one-hot of each waveform's quantized classes, what that model
        was trained on (the JAX path feeds the raw [B, T, 1] waveform there
        and fails on the first conv's shape)."""
        wn = self.cfg.wavenet
        c, frame_lengths = self._prepare_mels(mels)
        hop = self.cfg.audio.effective_hop
        T = c.shape[1] * hop
        x = np.zeros((len(wavs), T, 1), np.float32)
        for i, w in enumerate(wavs):
            x[i, :min(len(w), T), 0] = w[:T]
        x = torch.as_tensor(x, device=self.device)
        if self.kind == "categorical":
            q = mulaw_quantize(x[..., 0], wn.quantize_channels - 1).long()
            x = torch.nn.functional.one_hot(q, wn.quantize_channels).float()
        y_hat, _ = self.model(x, torch.as_tensor(c, device=self.device))
        if self.kind == "gaussian":
            pred = y_hat[..., 0]
        elif self.kind == "categorical":
            pred = inv_mulaw_quantize(y_hat.argmax(-1).to(torch.int32),
                                      wn.quantize_channels - 1)
        else:
            if noise is None:
                g = torch.Generator(device=self.device).manual_seed(0)
                lo, hi = 1e-5, 1.0 - 1e-5
                u = lambda *s: torch.rand(*s, generator=g,
                                          device=self.device) * (hi - lo) + lo
                noise = (u(*y_hat.shape[:2], y_hat.shape[-1] // 3),
                         u(*y_hat.shape[:2]))
            temp, u = (torch.as_tensor(np.asarray(n), device=self.device)
                       for n in noise)
            pred = sample_from_discretized_mix_logistic(y_hat, temp, u)
        pred = pred.float().cpu().numpy()
        return [pred[i, :n * hop] for i, n in enumerate(frame_lengths)]


def run_synthesis(synth: WaveNetSynthesizer, map_path: str, output_dir: str,
                  batch_size: Optional[int] = None,
                  limit: Optional[int] = None) -> List[str]:
    """Vocode every mel of a map.txt (reference wavenet synthesize.py:12-78)
    into <output_dir>/wavs/wavenet-<mel name>.wav. A GTA map row names its
    mel in column 2, an eval map row in column 0. The last batch is filled
    to the full batch with repeats of its last mel, whose results are
    dropped. Returns the wav paths."""
    out_dir = os.path.join(output_dir, "wavs")
    plot_dir = os.path.join(output_dir, "plots")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(plot_dir, exist_ok=True)
    with open(map_path, encoding="utf-8") as f:
        rows = [line.strip().split("|") for line in f if line.strip()]
    if limit:
        rows = rows[:limit]
    bs = batch_size or synth.cfg.train.wavenet_synthesis_batch_size
    paths = []
    for start in range(0, len(rows), bs):
        chunk = rows[start:start + bs]
        mel_paths = [r[2] if len(r) >= 4 else r[0] for r in chunk]
        mels = [np.load(p) for p in mel_paths]
        n_real = len(mels)
        if n_real < bs:
            mels = mels + [mels[-1]] * (bs - n_real)
        wavs = synth.synthesize(mels)[:n_real]
        for p, wav in zip(mel_paths, wavs):
            name = os.path.splitext(os.path.basename(p))[0]
            wav_path = os.path.join(out_dir, f"wavenet-{name}.wav")
            host_audio.save_wav(wav, wav_path, synth.cfg.audio.sample_rate)
            waveplot(os.path.join(plot_dir, f"wavenet-{name}.png"), wav,
                     None, synth.cfg.audio.sample_rate)
            paths.append(wav_path)
        log(f"vocoded {min(start + bs, len(rows))}/{len(rows)}")
    return paths
