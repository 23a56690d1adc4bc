"""Single-program text→waveform serving chain (PyTorch/CUDA).

Port of tacotron2_tpu/synth/pipeline.py `TextToWavProgram` (:47): Tacotron
memory pass → the CUDA decode kernel → postnet → stop-length recovery and
silence masking (:194-207) → [0, 1] rescale (:215-220) → the conditioning
upsample of any `upsample_type` (:221-229) → the CUDA sampler kernel (its
plain version on the card at widths the kernel does not take,
`wavenet_kernel.takes_kernel`), on one device with no host round trip
between the stages. The sampler takes whichever output head the config
names (Gaussian, mixture of logistics, categorical), with the JAX
program's dtype rule (:127-140): `sampler_bf16=None` runs a bf16 delay
cache and bf16 weights on a CUDA device and f32 on the CPU;
`wavenet.sampler_cache_dtype` / `sampler_weight_dtype` = "bfloat16" force
bf16 for either. With `vocoder="griffin_lim"` (:209-213) the masked mel
goes through Griffin-Lim (the CUDA Griffin-Lim kernel) instead of the
upsample and the sampler. A vocoder with global conditioning is sampled
without its speaker, as the JAX program does; one without local
conditioning (cin_channels <= 0) raises ValueError at the upsample on the
first call, where the JAX program fails with an AttributeError. CPU
tensors run the same chain through the kernels' plain versions (that is
how the tests hold it against the JAX program). Each stage runs once over
the whole batch: the decode kernel runs one thread-block cluster per row,
so the TPU program's split into decode chunks of at most 64 rows has no
counterpart.

Random numbers come from one `torch.Generator` on the program's device,
reseeded per call from a counter: the prenet dropout multipliers of every
decode step and the sampler's noise planes (`distributions.draw_noise`)
are drawn up front and passed into the kernels.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import convert
from ..config import Config
from ..models.tacotron.decoder import drop_masks, kernel_prenet
from ..models.wavenet.distributions import draw_noise
from ..models.wavenet.sampler import extract_sampler_params
from ..ops import griffin_lim
from ..ops import tacotron_decoder_kernel as dk
from ..ops import wavenet_kernel as wk
from ..ops.mulaw import inv_mulaw, inv_mulaw_quantize


class TextToWavProgram:
    """Padded text ids → waveform samples for one (batch, t_in, steps)
    serving bucket. Eligibility mirrors the JAX program (:47-75): no
    `emt_attn` (the JAX program refuses it: its variants go through the
    per-stage synthesizer), equal-width prenet, padded text ≤ 256,
    kernel_size 3; with or without GST (`gst.use_gst=False`, the `paper`
    preset) and with `emt_only` (no speaker reference encoder). `vocoder`
    is "wavenet" or "griffin_lim" (then `wn_params` may be None).
    `sampler_bf16` is the JAX program's switch (see the module note).

    `keep_intermediates=True` keeps the last call's kernel inputs
    (keys, memory, mask, dropout multipliers, conditioning, noise) in
    `self.intermediates`, so a check can replay each kernel against its
    plain version on the same numbers. On a CUDA device the kernels'
    operands (`dec_kernel`, `sampler_kernel`) are laid out once, here.
    """

    def __init__(self, cfg: Config, taco_params, batch_stats, wn_params, *,
                 batch: int, steps: int, t_in: int, t_ref: int = 64,
                 device="cuda", seed: int = 0,
                 keep_intermediates: bool = False,
                 sampler_bf16: bool | None = None,
                 vocoder: str = "wavenet", emt_only: bool = False):
        tc, au, wn = cfg.tacotron, cfg.audio, cfg.wavenet
        if vocoder not in ("wavenet", "griffin_lim"):
            raise ValueError(f"vocoder={vocoder!r}: wavenet or griffin_lim")
        self.vocoder = vocoder
        if cfg.gst.emt_attn:
            raise ValueError("TextToWavProgram refuses emt_attn, as the JAX "
                             "program does: TacotronSynthesizer serves it")
        if not kernel_prenet(cfg):
            raise ValueError(
                f"TextToWavProgram refuses tacotron.prenet_layers="
                f"{tuple(tc.prenet_layers)}: its decode kernel takes two "
                "layers of one width, as the JAX program's does; "
                "TacotronSynthesizer serves any prenet")
        if vocoder == "wavenet" and wn.kernel_size != 3:
            raise ValueError(
                f"TextToWavProgram refuses wavenet.kernel_size="
                f"{wn.kernel_size}: its sampler's delay lines take 3 taps, "
                "as the JAX program's kernel asserts "
                "(ops/wavenet_kernel.py:219); WaveNetSynthesizer samples "
                "any kernel_size")
        if t_in > 256:
            raise ValueError(f"t_in={t_in}: the program serves up to 256 "
                             "padded characters, as the JAX program's "
                             "whole-decode kernel does")
        self.cfg, self.device = cfg, torch.device(device)
        self.batch, self.steps, self.t_in, self.t_ref = batch, steps, t_in, t_ref
        self.hop = au.effective_hop
        self.frames = steps * tc.outputs_per_step
        # Griffin-Lim gives hop·(frames-1) samples (mels_to_wavs' trim)
        self.t_audio = self.hop * (self.frames - (vocoder == "griffin_lim"))

        self.taco = convert.tacotron_from_flax(cfg, taco_params,
                                               batch_stats or {}, device,
                                               emt_only)
        self.dec_params = dk.extract_decoder_params(taco_params, cfg,
                                                    device=device,
                                                    emt_only=emt_only)
        cuda = self.device.type == "cuda"
        self.dec_kernel = (dk.pack_weights(self.dec_params) if cuda
                           else None)
        self.wavenet = self.sampler_params = self.sampler_kernel = None
        if sampler_bf16 is None:
            sampler_bf16 = cuda
        sdt = torch.bfloat16 if sampler_bf16 else torch.float32
        bf = lambda name: torch.bfloat16 if name == "bfloat16" else sdt
        self.cache_dtype = bf(wn.sampler_cache_dtype)
        self.weight_dtype = bf(wn.sampler_weight_dtype)
        if vocoder == "wavenet":
            self.wavenet = convert.wavenet_from_flax(cfg, wn_params, device)
            self.sampler_params = extract_sampler_params(wn_params, cfg,
                                                         device)
            self.sampler_kernel = (
                wk.pack_weights(self.sampler_params, cfg,
                                cache_dtype=self.cache_dtype,
                                weight_dtype=self.weight_dtype)
                if wk.takes_kernel(cfg, self.device, self.weight_dtype)
                else None)
        self.memory_width = self.taco.memory_width
        self.generator = torch.Generator(device=self.device)
        self._seed = seed
        self.keep_intermediates = keep_intermediates
        self.intermediates = {}

    # ------------------------------------------------------------ program

    @torch.no_grad()
    def _forward(self, inputs, input_lengths, refs_emt, refs_spk):
        cfg, au = self.cfg, self.cfg.audio
        tc = cfg.tacotron
        r, B = tc.outputs_per_step, self.batch
        g = self.generator
        keys, memory, mask, _, _ = self.taco.synthesis_memory_ext(
            inputs, input_lengths, refs_emt, refs_spk)
        drop = drop_masks(cfg, B, self.steps, g, self.device)
        frames, stops, _ = dk.decode(
            self.dec_params, cfg, keys, memory, mask, drop, steps=self.steps,
            early_stop_block=tc.early_stop_block, emit_alignments=False,
            kernel_weights=self.dec_kernel)
        _, mel = self.taco.postnet_pass(frames)     # [B, frames, mels]

        # stop-length recovery (first frame whose stop prob rounds to 1,
        # else the full length; at least one reduction group)
        fired = stops >= 0.5
        first = torch.argmax(fired.float(), dim=1)
        mel_len = torch.where(fired.any(1), first,
                              torch.full_like(first, self.frames))
        mel_len = torch.clamp(mel_len, min=r)

        # mask the tail to normalized silence
        lo = -au.max_abs_value if au.symmetric_mels else 0.0
        pad_val = lo if au.signal_normalization else \
            (au.min_level_db - au.ref_level_db)
        idx = torch.arange(self.frames, device=mel.device)[None, :, None]
        mel = torch.where(idx < mel_len[:, None, None], mel,
                          torch.full_like(mel, pad_val))
        if self.keep_intermediates:
            self.intermediates = dict(keys=keys, memory=memory, mask=mask,
                                      drop=drop)

        if self.vocoder == "griffin_lim":
            samples = griffin_lim.inv_mel_spectrogram(mel, au)
            samples = samples[:, :self.t_audio]
            wav_len = torch.clamp(mel_len * self.hop, max=self.t_audio)
            return samples, wav_len, mel, stops, mel_len

        c = mel
        if au.clip_for_wavenet:
            c = torch.clamp(c, lo, au.max_abs_value)
        if au.normalize_for_wavenet:
            c = (c - lo) / (au.max_abs_value - lo)
        c_up = self.wavenet.upsample(c)
        noise = draw_noise(cfg, B, self.t_audio, g, self.device)
        sample = (wk.sample_plain if self.sampler_kernel is None else
                  partial(wk.sample, kernel_weights=self.sampler_kernel))
        samples = sample(self.sampler_params, cfg, c_up, noise,
                         cache_dtype=self.cache_dtype,
                         weight_dtype=self.weight_dtype)
        if self.keep_intermediates:
            self.intermediates.update(c_up=c_up, noise=noise)
        return samples, mel_len * self.hop, mel, stops, mel_len

    # ------------------------------------------------------------- public

    def __call__(self, inputs, input_lengths, refs_emt, refs_spk):
        """Run the program. Returns (samples [B, t_audio], wav_lengths [B],
        mel [B, frames, mels], stop_probs [B, frames], mel_lengths [B]) as
        tensors on the program's device. Trim with
        `samples[i, :wav_lengths[i]]`."""
        args = self._operands(inputs, input_lengths, refs_emt, refs_spk)
        self._seed += 1
        self.generator.manual_seed(self._seed)
        return self._forward(*args)

    def sharded_call(self, dp, inputs, input_lengths, refs_emt, refs_spk):
        """Serving over a data-parallel group (JAX `sharded_call`,
        pipeline.py:259-295): the inputs are the global batch, world × the
        program's batch rows, alike on every rank; rank r runs the whole
        program on its rows [r·batch, (r+1)·batch) with its generator
        seeded as JAX seeds shard r (`seed + r·n_chunks`, one chunk a call
        here): the call counter moves by the world size, and rank r takes
        the counter + r. No collective runs inside the program; the five
        outputs are gathered in row order and returned on every rank."""
        from ..parallel import dist
        n = len(inputs)
        if n != dp.world * self.batch:
            raise ValueError(f"global batch {n} != {dp.world} ranks x "
                             f"{self.batch}")
        rows = slice(dp.rank * self.batch, (dp.rank + 1) * self.batch)
        args = self._operands(inputs[rows], input_lengths[rows],
                              refs_emt[rows], refs_spk[rows])
        self._seed += dp.world
        self.generator.manual_seed(self._seed + dp.rank)
        return tuple(dist.all_gather_rows(o.contiguous(), dp)
                     for o in self._forward(*args))

    def _operands(self, inputs, input_lengths, refs_emt, refs_spk):
        """The call's inputs as tensors on the device, their shapes
        checked."""
        nm = self.cfg.audio.num_mels
        dev = self.device
        inputs = torch.as_tensor(np.asarray(inputs), device=dev).long()
        lengths = torch.as_tensor(np.asarray(input_lengths), device=dev).long()
        refs_emt = torch.as_tensor(np.asarray(refs_emt, np.float32), device=dev)
        refs_spk = torch.as_tensor(np.asarray(refs_spk, np.float32), device=dev)
        if tuple(inputs.shape) != (self.batch, self.t_in):
            raise ValueError(f"expected {(self.batch, self.t_in)}, got "
                             f"{tuple(inputs.shape)}")
        for name, ref in (("refs_emt", refs_emt), ("refs_spk", refs_spk)):
            if tuple(ref.shape) != (self.batch, self.t_ref, nm):
                raise ValueError(f"{name} must be "
                                 f"{(self.batch, self.t_ref, nm)}, got "
                                 f"{tuple(ref.shape)}")
        return inputs, lengths, refs_emt, refs_spk

    def synthesize(self, texts, ref_mels_emt, ref_mels_spk):
        """Texts and reference mels -> list of trimmed float32 wavs.

        Batches shorter than the bucket are filled with repeats of their
        rows and trimmed after; longer ones run in several calls."""
        from ..text import text_to_sequence
        n = len(texts)
        if not (n > 0 and len(ref_mels_emt) == n and len(ref_mels_spk) == n):
            raise ValueError("need one emt and one spk reference per text")
        seqs = [np.asarray(text_to_sequence(t, self.cfg.data.cleaners),
                           np.int64) for t in texts]
        lengths = np.asarray([len(s) for s in seqs], np.int64)
        if int(lengths.max()) > self.t_in:
            raise ValueError(f"text longer than the program's "
                             f"t_in={self.t_in} bucket")
        inputs = np.stack([np.pad(s, (0, self.t_in - len(s))) for s in seqs])
        pad_val = -self.cfg.audio.max_abs_value

        def pad_ref(m):
            m = np.asarray(m, np.float32)[:self.t_ref]
            return np.pad(m, ((0, self.t_ref - len(m)), (0, 0)),
                          constant_values=pad_val)

        refs_e = np.stack([pad_ref(m) for m in ref_mels_emt])
        refs_s = np.stack([pad_ref(m) for m in ref_mels_spk])
        samples_l, wav_len_l = [], []
        for i in range(0, n, self.batch):
            sl = slice(i, i + self.batch)
            ii, ll, re_, rs = inputs[sl], lengths[sl], refs_e[sl], refs_s[sl]
            short = self.batch - len(ii)
            if short:                      # fill the bucket with row repeats
                fill = np.arange(short) % len(ii)
                ii, ll = np.concatenate([ii, ii[fill]]), np.concatenate(
                    [ll, ll[fill]])
                re_, rs = np.concatenate([re_, re_[fill]]), np.concatenate(
                    [rs, rs[fill]])
            s, wl, _, _, _ = self(ii, ll, re_, rs)
            take = self.batch - short
            samples_l.append(s.cpu().numpy()[:take])
            wav_len_l.append(wl.cpu().numpy()[:take])
        samples = np.concatenate(samples_l)
        wav_len = np.concatenate(wav_len_l)
        wavs = [samples[i, :wav_len[i]] for i in range(n)]
        if self.vocoder == "griffin_lim":
            # the host undoes the preemphasis, as the reference does
            # (tacotron/train.py:660)
            from ..data import audio as host_audio
            a = self.cfg.audio
            wavs = [host_audio.inv_preemphasis(w, a.preemphasis,
                                               a.preemphasize) for w in wavs]
        elif self.cfg.wavenet.input_type == "mulaw":
            q = self.cfg.wavenet.quantize_channels - 1
            wavs = [np.asarray(inv_mulaw(w, q), np.float32) for w in wavs]
        elif self.cfg.wavenet.input_type == "mulaw-quantize":
            # class indices -> waveform, as the per-stage synthesizer does
            # (the JAX program returns the indices)
            q = self.cfg.wavenet.quantize_channels - 1
            wavs = [np.asarray(inv_mulaw_quantize(w.astype(np.int32), q),
                               np.float32) for w in wavs]
        return wavs
