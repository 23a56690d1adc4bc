"""Tacotron synthesizer: checkpointed weights -> mels, alignments, wavs.

Port of tacotron2_tpu/synth/tacotron_synth.py for the eval mode:
`TacotronSynthesizer` with `prepare_inputs` (:273), `_pad_refs` (:283),
`get_output_lengths` (:290), `synthesize` (:299, not GTA), `mel_to_wav`,
`mels_to_wavs` (:388) and `gl_pad_value` (:36), and `run_eval` (:453)
without its plots.

The decode takes the routes the JAX synthesizer takes on the TPU
(:350-365), both through the CUDA decode kernel (`ops/tacotron_decoder_
kernel.py`) on a CUDA device and through its plain version on the CPU:

- padded text <= 256 (`_fused_synth`, the TPU's `build_decoder_kernel`
  route): the whole decode with the batch-wide early stop every
  `tacotron.early_stop_block` steps, as a chain of block launches;
- longer text with 0 < early_stop_block < max_steps (`_fused_block_synth`,
  the TPU's `build_decoder_block_kernel` route): blocks of
  `tacotron.fused_block_steps` steps from explicit state, the host
  stopping once every row has fired (:241-246);
- longer text without an early stop decodes all steps in one chain, as
  the JAX package's one-shot scan does.

There is no VMEM gate: the kernel raises where a width does not fit its
shared memory. Prenet dropout multipliers come from the synthesizer's
`torch.Generator`. Wavs come from the batched Griffin-Lim
(`ops/griffin_lim.py`), whose CUDA path is the Griffin-Lim kernel.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..config import Config
from ..data import audio as host_audio
from ..models.tacotron.decoder import drop_masks, stop_fired
from ..ops import griffin_lim
from ..ops import tacotron_decoder_kernel as dk
from ..text import text_to_sequence
from ..utils import log


def _round_up(x: int, m: int) -> int:
    return x if x % m == 0 else x + m - x % m


def gl_pad_value(a) -> float:
    """Mel value that pads a Griffin-Lim batch: it must denormalise to
    min_level_db silence, not to a loud frame."""
    if a.signal_normalization:
        return -a.max_abs_value if a.symmetric_mels else 0.0
    return a.min_level_db - a.ref_level_db


class TacotronSynthesizer:
    """Tacotron weights (flax trees of numpy arrays) bound for batched
    synthesis on `device`. `keep_intermediates=True` keeps the last
    decode's inputs (keys, memory, mask, the first block's dropout
    multipliers, the route) in `self.intermediates`, so a check can replay
    the kernel against its plain version on the same numbers."""

    def __init__(self, cfg: Config, params, batch_stats=None, *,
                 device="cuda", seed: int = 0,
                 keep_intermediates: bool = False):
        tc = cfg.tacotron
        assert not cfg.gst.emt_attn, "emt_attn is not in the port yet"
        assert len(set(tc.prenet_layers)) == 1, "kernel wants equal prenet FCs"
        self.cfg, self.device = cfg, torch.device(device)
        self.taco = convert.tacotron_from_flax(cfg, params, batch_stats or {},
                                               device)
        self.dec_params = dk.extract_decoder_params(params, cfg,
                                                    device=device)
        self.dec_kernel = (dk.pack_weights(self.dec_params)
                           if self.device.type == "cuda" else None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.keep_intermediates = keep_intermediates
        self.intermediates: Dict[str, object] = {}

    # ------------------------------------------------------------- inputs

    def prepare_inputs(self, texts: Sequence[str], pad_multiple: int = 16
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Texts -> padded id matrix and lengths."""
        seqs = [np.asarray(text_to_sequence(t, self.cfg.data.cleaners),
                           np.int64) for t in texts]
        lengths = np.asarray([len(s) for s in seqs], np.int64)
        max_len = _round_up(int(lengths.max()), pad_multiple)
        inputs = np.stack([np.pad(s, (0, max_len - len(s))) for s in seqs])
        return inputs, lengths

    def _pad_refs(self, refs: Sequence[np.ndarray], pad_multiple: int = 64):
        pad_val = -self.cfg.audio.max_abs_value
        max_len = _round_up(max(len(r) for r in refs), pad_multiple)
        return np.stack([
            np.pad(r, ((0, max_len - len(r)), (0, 0)), constant_values=pad_val)
            for r in refs]).astype(np.float32)

    def get_output_lengths(self, stop_probs: np.ndarray) -> List[int]:
        """First index whose stop probability rounds to 1, else the full
        length."""
        out = []
        for row in np.round(np.asarray(stop_probs)).astype(np.int32):
            idx = np.flatnonzero(row == 1)
            out.append(int(idx[0]) if len(idx) else len(row))
        return out

    # ------------------------------------------------------------- decode

    def _memory(self, inputs, input_lengths, refs_emt, refs_spk):
        t = lambda x, dt=None: torch.as_tensor(x, device=self.device,
                                               dtype=dt)
        return self.taco.synthesis_memory_ext(
            t(inputs, torch.long), t(input_lengths, torch.long),
            t(refs_emt, torch.float32), t(refs_spk, torch.float32))[:3]

    def _fused_synth(self, keys, memory, mask, steps: int):
        """The whole decode, with the batch-wide early stop."""
        B = memory.shape[0]
        drop = drop_masks(self.cfg, B, steps, self.generator, self.device)
        if self.keep_intermediates:
            self.intermediates.update(route="fused", drop=drop)
        frames, stops, aligns = dk.decode(
            self.dec_params, self.cfg, keys, memory, mask, drop, steps=steps,
            early_stop_block=self.cfg.tacotron.early_stop_block,
            kernel_weights=self.dec_kernel)
        return frames, stops, aligns

    def _fused_block_synth(self, keys, memory, mask, steps: int, k: int):
        """Blocks of k steps from explicit state; the host stops once every
        row has fired (the reference dynamic_decode exit)."""
        tc = self.cfg.tacotron
        r = tc.outputs_per_step
        B, T, M = memory.shape
        state = dk.init_decoder_state(self.cfg, B, T, M, self.device)
        fired = torch.zeros(B, dtype=torch.bool, device=self.device)
        frames_l, stops_l, aligns_l = [], [], []
        for i in range(-(-steps // k)):
            drop = drop_masks(self.cfg, B, k, self.generator, self.device)
            if self.keep_intermediates and i == 0:
                self.intermediates.update(route="block", drop=drop, k=k)
            frames, stops, aligns, state = dk.decode_block(
                self.dec_params, self.cfg, keys, memory, mask, state, drop,
                kernel_weights=self.dec_kernel)
            frames_l.append(frames)
            stops_l.append(stops)
            aligns_l.append(aligns)
            fired |= stop_fired(stops.reshape(B, k, r),
                                tc.stop_at_any).any(1)
            if bool(fired.all()):
                break
        frames = torch.cat(frames_l, 1)[:, :steps * r]
        stops = torch.cat(stops_l, 1)[:, :steps * r]
        aligns = torch.cat(aligns_l, 2)[:, :, :steps]
        return frames, stops, aligns

    @torch.no_grad()
    def synthesize(self, texts: Sequence[str],
                   ref_mels_emt: Sequence[np.ndarray],
                   ref_mels_spk: Sequence[np.ndarray],
                   max_steps: Optional[int] = None
                   ) -> Dict[str, object]:
        """Batch synthesis: trimmed mels, alignments [T_in, steps], the raw
        stop probabilities and the lengths."""
        tc = self.cfg.tacotron
        inputs, input_lengths = self.prepare_inputs(texts)
        refs_emt = self._pad_refs(ref_mels_emt)
        refs_spk = self._pad_refs(ref_mels_spk)
        steps = max_steps or tc.max_iters
        k = tc.early_stop_block
        keys, memory, mask = self._memory(inputs, input_lengths, refs_emt,
                                          refs_spk)
        if self.keep_intermediates:
            self.intermediates = dict(keys=keys, memory=memory, mask=mask)
        if inputs.shape[1] > 256 and 0 < k < steps:
            kf = min(max(tc.fused_block_steps, 1), steps)
            frames, stops, aligns = self._fused_block_synth(
                keys, memory, mask, steps, kf)
        else:
            frames, stops, aligns = self._fused_synth(keys, memory, mask,
                                                      steps)
        _, mels = self.taco.postnet_pass(frames)
        stops = stops.cpu().numpy()
        lengths = self.get_output_lengths(stops)
        mels, aligns = mels.cpu().numpy(), aligns.cpu().numpy()
        m = self.cfg.audio.max_abs_value
        out_mels, out_aligns = [], []
        for i, L in enumerate(lengths):
            L = max(int(L), 1)
            out_mels.append(np.clip(mels[i, :L], -m, m))
            out_aligns.append(aligns[i, :input_lengths[i],
                                     :max(1, L // tc.outputs_per_step)])
        return dict(mels=out_mels, alignments=out_aligns, stop_tokens=stops,
                    lengths=lengths)

    # -------------------------------------------------------------- vocode

    def mel_to_wav(self, mel: np.ndarray) -> np.ndarray:
        """Griffin-Lim inversion of one mel, then inverse preemphasis."""
        a = self.cfg.audio
        wav = griffin_lim.inv_mel_spectrogram(
            torch.as_tensor(np.asarray(mel, np.float32), device=self.device),
            a).cpu().numpy()
        return host_audio.inv_preemphasis(wav, a.preemphasis, a.preemphasize)

    @torch.no_grad()
    def mels_to_wavs(self, mels: Sequence[np.ndarray],
                     max_batch: int = 32) -> list:
        """Batched Griffin-Lim of variable-length mels: padded with
        `gl_pad_value` to a common frame count (a multiple of 64, plus one),
        at most `max_batch` a call, each waveform trimmed to its own
        hop·(frames-1) samples. The padding frames take part in the phase
        iterations, so a wav differs slightly near its tail from
        `mel_to_wav` of the same mel (the JAX package's documented
        divergence)."""
        if not len(mels):
            return []
        if len(mels) > max_batch:
            out = []
            for i in range(0, len(mels), max_batch):
                out.extend(self.mels_to_wavs(mels[i:i + max_batch],
                                             max_batch))
            return out
        a = self.cfg.audio
        pad_val = gl_pad_value(a)
        F = _round_up(max(m.shape[0] for m in mels), 64) + 1
        batch = np.stack([np.pad(np.asarray(m, np.float32),
                                 ((0, F - m.shape[0]), (0, 0)),
                                 constant_values=pad_val) for m in mels])
        wavs = griffin_lim.inv_mel_spectrogram(
            torch.as_tensor(batch, device=self.device), a).cpu().numpy()
        hop = a.effective_hop
        return [host_audio.inv_preemphasis(wavs[i, : hop * (m.shape[0] - 1)],
                                           a.preemphasis, a.preemphasize)
                for i, m in enumerate(mels)]


# -------------------------------------------------------------- entry points


def run_eval(synth: TacotronSynthesizer, sentences: Sequence[str],
             ref_mels_emt, ref_mels_spk, output_dir: str,
             save_wavs: bool = True) -> str:
    """Sentences -> <output_dir>/eval/{mels/mel-eval-i.npy, map.txt,
    wavs/wav-eval-i.wav}; each wav gets the reference's trailing 0.5 s of
    silence. Returns the path of map.txt."""
    eval_dir = os.path.abspath(os.path.join(output_dir, "eval"))
    os.makedirs(os.path.join(eval_dir, "mels"), exist_ok=True)
    if save_wavs:
        os.makedirs(os.path.join(eval_dir, "wavs"), exist_ok=True)
    result = synth.synthesize(sentences, ref_mels_emt, ref_mels_spk)
    wavs = synth.mels_to_wavs(result["mels"]) if save_wavs else []
    sr = synth.cfg.audio.sample_rate
    map_rows = []
    for i, (text, mel) in enumerate(zip(sentences, result["mels"])):
        mel_path = os.path.join(eval_dir, "mels", f"mel-eval-{i}.npy")
        np.save(mel_path, mel, allow_pickle=False)
        map_rows.append(f"{mel_path}|{text}")
        if save_wavs:
            wav = np.concatenate([wavs[i], np.zeros(sr // 2, np.float32)])
            host_audio.save_wav(wav, os.path.join(eval_dir, "wavs",
                                                  f"wav-eval-{i}.wav"), sr)
    map_path = os.path.join(eval_dir, "map.txt")
    with open(map_path, "w", encoding="utf-8") as f:
        f.write("\n".join(map_rows) + "\n")
    log(f"wrote eval synthesis for {len(sentences)} sentences -> {eval_dir}")
    return map_path
