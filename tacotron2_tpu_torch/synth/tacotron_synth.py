"""Tacotron synthesizer: checkpointed weights -> mels, alignments, wavs.

Port of tacotron2_tpu/synth/tacotron_synth.py: `TacotronSynthesizer` with
`prepare_inputs` (:273), `_pad_refs` (:283), `get_output_lengths` (:290),
`synthesize` (:311, eval and GTA), `mel_to_wav`, `mels_to_wavs` (:388),
`embed` (:427) and `gl_pad_value` (:36); and the drivers of every
`synthesize --mode` of the Tacotron stage: `run_eval` (:453, with its
alignment and mel plots under eval/plots/), `run_gta_synthesis` (:497),
`run_style_transfer` (:578, alignment plots under natural/plots/; the
plots where matplotlib imports, `utils/plot.py`), `run_synthesis_random`
(:631), `run_synthesis_multiple` (:692) and `run_style_embs` (:780),
with `_read_meta` (:534) and `_resolve_refs` (:540). Their numpy RNG
picks the same rows as the JAX functions'.

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

Under `gst.emt_attn` (the Tacotron_emt_attn variant) the routes are the
JAX synthesizer's for it (:345-365): `simple` and `multihead` run the
block route whenever 0 < early_stop_block < max_steps, whatever the text's
length (on the TPU its block kernel with the emt scorers; here the CUDA
kernel's emt mode), and else one chain of blocks without an early stop
(route "fused"); `style_tokens`, which the JAX package decodes with its XLA
scan and no kernel on every device, decodes through the plain version on
the synthesizer's device (route "plain"), all steps, with the emotion
labels (`synthesize(emt_labels=...)`, label 0 when none are given). A
prenet other than two layers of one width, which the JAX synthesizer
sends to its scan (its eligibility, :167,185, admits three equal layers,
which its kernels then refuse), decodes through the plain version too
(route "plain"), with the batch-wide early stop every early_stop_block
steps as the JAX scan's blocks (:230-246), none under style_tokens
(`plain_synthesis` is the one predicate).

GTA synthesis and `embed` run `Tacotron.gta_pass`, whose teacher-forced
decode takes every coin as 1 (`ops/tacotron_train_kernel.py`: the
teacher-forced mode of the decode kernel on a CUDA device, its plain
version on the CPU; route "teacher_forced"), with weights in
`tacotron.fused_train_dtype`; it returns stop logits, as the JAX GTA route
does. Under `tacotron.smoothing`, `gst.emt_attn` or a prenet other than
(P, P) that decode is the plain version on the synthesizer's device (route
"teacher_forced_plain"), as the JAX package scans it
(`models/tacotron/decoder.py:teacher_forced_route`); under emt_attn it
attends over the emotion reference's sequence, with `emt_labels` for
style_tokens (label 0 without, as JAX), and GTA returns its alignments.
AdaIN's style (the speaker embedding of its one reference encoder) runs
in every mode; `embed` then gives no emotion embedding, and `style_embs`
raises there, and under emt_attn, as JAX's `run_style_embs` fails.

Every route reads its weight dtype from the config (`fused_decoder_dtype`
for the free-running decode, `fused_train_dtype` for the teacher-forced
one; bf16 or f32, never cast down behind the caller's back) and its
attention (softmax or `tacotron.smoothing`).

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
from ..models.tacotron.decoder import (drop_masks, emt_operands,
                                      kernel_prenet, stop_fired,
                                      teacher_forced, teacher_forced_route)
from ..ops import griffin_lim
from ..ops import tacotron_decoder_kernel as dk
from ..ops import tacotron_train_kernel as tk
from ..text import text_to_sequence
from ..utils import log
from ..utils.plot import plot_alignment, plot_spectrogram


def _round_up(x: int, m: int) -> int:
    return x if x % m == 0 else x + m - x % m


def plain_synthesis(cfg: Config) -> bool:
    """Whether the free-running decode takes the plain version on every
    device, as the JAX synthesizer scans it: style_tokens, or a prenet
    other than two layers of one width."""
    gst = cfg.gst
    return ((gst.emt_attn and gst.emt_attn_type == "style_tokens")
            or not kernel_prenet(cfg))


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
    multipliers, the route; for GTA the teacher and the coins) in
    `self.intermediates`, so a check can replay the kernel against its
    plain version on the same numbers."""

    def __init__(self, cfg: Config, params, batch_stats=None, *,
                 device="cuda", seed: int = 0,
                 keep_intermediates: bool = False, emt_only: bool = False,
                 pretrained_emb_disc_all: bool = False):
        self.cfg, self.device = cfg, torch.device(device)
        self.taco = convert.tacotron_from_flax(
            cfg, params, batch_stats or {}, device, emt_only,
            pretrained_emb_disc_all=pretrained_emb_disc_all)
        self.dec_params = dk.extract_decoder_params(params, cfg,
                                                    device=device,
                                                    emt_only=emt_only)
        self.emt_params = dk.extract_emt_params(params, cfg, device=device,
                                                emt_only=emt_only)
        # a prenet other than the kernels' (None for theirs)
        self.prenet = (None if kernel_prenet(cfg)
                       else dk.extract_prenet(params, cfg, device=device))
        # the plain decode takes no kernel weights
        self.plain_decode = plain_synthesis(cfg)
        self.dec_kernel = (dk.pack_weights(self.dec_params,
                                           emt=self.emt_params)
                           if self.device.type == "cuda"
                           and not self.plain_decode else None)
        self._params = params
        self._tf_weights = None
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

    def teacher_forced_weights(self):
        """(DecoderParams, KernelWeights or None) of the teacher-forced
        decode in `fused_train_dtype`: the autoregressive decode's own
        where the two dtypes agree, else extracted once (kernel weights on
        the kernel route on a CUDA device only); `teacher_forced_prenet`
        gives a prenet other than (P, P) in that dtype."""
        if self._tf_weights is None:
            wd = tk.train_weight_dtype(self.cfg)
            if wd == dk.decode_weight_dtype(self.cfg):
                self._tf_weights = (self.dec_params, self.dec_kernel)
            else:
                dp = dk.extract_decoder_params(
                    self._params, self.cfg, device=self.device,
                    weight_dtype=wd)
                kernel = (self.device.type == "cuda"
                          and teacher_forced_route(self.cfg) == "kernel")
                self._tf_weights = (
                    dp, dk.pack_weights(dp) if kernel else None)
        return self._tf_weights

    def teacher_forced_prenet(self):
        """The plain teacher-forced decode's `prenet` in
        `fused_train_dtype` (None for the kernels' (P, P))."""
        wd = tk.train_weight_dtype(self.cfg)
        if self.prenet is None or wd == dk.decode_weight_dtype(self.cfg):
            return self.prenet
        return dk.extract_prenet(self._params, self.cfg, device=self.device,
                                 weight_dtype=wd)

    def _gta_decode(self, keys, memory, mask, teacher, emt=None):
        """The teacher-forced decode with every coin 1 (GTA's ratio), with
        the emt operands under emt_attn -> (frames, stop logits,
        alignments, alignments_emt or None)."""
        B, steps = memory.shape[0], teacher.shape[0]
        drop = drop_masks(self.cfg, B, steps, self.generator, self.device)
        coins = torch.ones(steps, dtype=torch.int32, device=self.device)
        kernel = teacher_forced_route(self.cfg) == "kernel"
        if self.keep_intermediates:
            self.intermediates = dict(
                route="teacher_forced" if kernel else "teacher_forced_plain",
                keys=keys, memory=memory, mask=mask, teacher=teacher,
                coins=coins, drop=drop)
        dp, kw = self.teacher_forced_weights()
        if not kernel:
            out = teacher_forced(dp, self.cfg, keys, memory, mask, teacher,
                                 coins, drop, emt=emt,
                                 prenet=self.teacher_forced_prenet())
            return out if emt is not None else (*out, None)
        return (*tk.teacher_forced_fwd(dp, self.cfg, keys, memory, mask,
                                       teacher, coins, drop,
                                       kernel_weights=kw), None)

    def _gta_pass(self, texts, refs_emt, refs_spk, targets,
                  synth_embeddings=False, emt_labels=None):
        """Padded refs and targets (numpy) -> `Tacotron.gta_pass`'s dict and
        the input lengths."""
        inputs, input_lengths = self.prepare_inputs(texts)
        t = lambda x, dt: torch.as_tensor(x, device=self.device, dtype=dt)
        out = self.taco.gta_pass(
            t(inputs, torch.long), t(input_lengths, torch.long),
            t(targets, torch.float32), t(refs_emt, torch.float32),
            t(refs_spk, torch.float32), self._gta_decode,
            synth_embeddings=synth_embeddings,
            emt_labels=(None if emt_labels is None
                        else t(np.asarray(emt_labels), torch.long)))
        return out, input_lengths

    def _memory(self, inputs, input_lengths, refs_emt, refs_spk):
        """-> (keys, memory, mask, emt_memory, ref_spk)."""
        t = lambda x, dt=None: torch.as_tensor(x, device=self.device,
                                               dtype=dt)
        return self.taco.synthesis_memory_ext(
            t(inputs, torch.long), t(input_lengths, torch.long),
            t(refs_emt, torch.float32), t(refs_spk, torch.float32))

    def _fused_synth(self, keys, memory, mask, steps: int, emt=None):
        """The whole decode, with the batch-wide early stop."""
        B = memory.shape[0]
        drop = drop_masks(self.cfg, B, steps, self.generator, self.device)
        if self.keep_intermediates:
            self.intermediates.update(route="fused", drop=drop)
        frames, stops, aligns = dk.decode(
            self.dec_params, self.cfg, keys, memory, mask, drop, steps=steps,
            early_stop_block=self.cfg.tacotron.early_stop_block,
            kernel_weights=self.dec_kernel, emt=emt)
        return frames, stops, aligns

    def _plain_synth(self, keys, memory, mask, steps: int, emt):
        """The plain decode, as the JAX package's XLA scan decodes
        style_tokens (every step) and any prenet other than (P, P) (blocks
        of early_stop_block steps with the batch-wide early stop), on the
        synthesizer's device."""
        B = memory.shape[0]
        tc, gst = self.cfg.tacotron, self.cfg.gst
        k = tc.early_stop_block
        if gst.emt_attn and gst.emt_attn_type == "style_tokens" \
                or not 0 < k < steps:
            k = 0
        drop = drop_masks(self.cfg, B, steps, self.generator, self.device)
        if self.keep_intermediates:
            self.intermediates.update(route="plain", drop=drop)
        return dk.decode_plain(self.dec_params, self.cfg, keys, memory, mask,
                               drop, steps=steps, early_stop_block=k,
                               emt=emt, prenet=self.prenet)

    def _fused_block_synth(self, keys, memory, mask, steps: int, k: int,
                           emt=None):
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
                kernel_weights=self.dec_kernel, emt=emt)
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
                   mel_targets: Optional[Sequence[np.ndarray]] = None,
                   gta: bool = False, max_steps: Optional[int] = None,
                   emt_labels: Optional[Sequence[int]] = None
                   ) -> Dict[str, object]:
        """Batch synthesis: trimmed mels, alignments [T_in, steps], the raw
        stop tokens and the lengths. Eval: free-running decode, stop
        probabilities, lengths from the stops. GTA (`gta=True`, the
        targets [T_i, mels] given): teacher-forced on the targets padded
        with -max_abs_value to a multiple of max(r, 64) frames, stop
        logits, the targets' lengths, and under emt_attn
        `alignments_emt`, the emt attention's alignments of each row [Te or
        1, steps]. `emt_labels` (one emotion id a text) drive the
        style_tokens emt_attn variant's attention query; it takes label 0
        without them (JAX :319-321)."""
        tc, gst = self.cfg.tacotron, self.cfg.gst
        refs_emt = self._pad_refs(ref_mels_emt)
        refs_spk = self._pad_refs(ref_mels_spk)
        if gta:
            if mel_targets is None:
                raise ValueError("GTA synthesis needs mel_targets")
            targets = self._pad_refs(mel_targets,
                                     max(tc.outputs_per_step, 64))
            out, input_lengths = self._gta_pass(texts, refs_emt, refs_spk,
                                                targets,
                                                emt_labels=emt_labels)
            got = self._trim(out["mel_outputs"], out["alignments"],
                             out["stop_token_prediction"].cpu().numpy(),
                             [len(m) for m in mel_targets], input_lengths)
            if out["alignments_emt"] is not None:
                got["alignments_emt"] = list(
                    out["alignments_emt"].cpu().numpy())
            return got
        inputs, input_lengths = self.prepare_inputs(texts)
        steps = max_steps or tc.max_iters
        k = tc.early_stop_block
        keys, memory, mask, emt_memory, ref_spk = self._memory(
            inputs, input_lengths, refs_emt, refs_spk)
        emt = None
        if gst.emt_attn:
            labels = None
            if gst.emt_attn_type == "style_tokens":
                labels = torch.as_tensor(
                    np.zeros(len(texts), np.int64) if emt_labels is None
                    else np.asarray(emt_labels, np.int64),
                    device=self.device)
            emt = emt_operands(self.emt_params, self.cfg, emt_memory,
                               ref_spk, labels)
        if self.keep_intermediates:
            self.intermediates = dict(keys=keys, memory=memory, mask=mask,
                                      emt=emt)
        kf = min(max(tc.fused_block_steps, 1), steps)
        if self.plain_decode:
            frames, stops, aligns = self._plain_synth(keys, memory, mask,
                                                      steps, emt)
        elif (gst.emt_attn or inputs.shape[1] > 256) and 0 < k < steps:
            frames, stops, aligns = self._fused_block_synth(
                keys, memory, mask, steps, kf, emt)
        else:
            frames, stops, aligns = self._fused_synth(keys, memory, mask,
                                                      steps, emt)
        _, mels = self.taco.postnet_pass(frames)
        stops = stops.cpu().numpy()
        return self._trim(mels, aligns, stops,
                          self.get_output_lengths(stops), input_lengths)

    def _trim(self, mels, aligns, stops, lengths, input_lengths):
        """Each row's mel to its length, clipped to ±max_abs_value, and its
        alignments to its text and steps."""
        r = self.cfg.tacotron.outputs_per_step
        mels, aligns = mels.cpu().numpy(), aligns.cpu().numpy()
        m = self.cfg.audio.max_abs_value
        out_mels, out_aligns = [], []
        for i, L in enumerate(lengths):
            L = max(int(L), 1)
            out_mels.append(np.clip(mels[i, :L], -m, m))
            out_aligns.append(aligns[i, :input_lengths[i], :max(1, L // r)])
        return dict(mels=out_mels, alignments=out_aligns, stop_tokens=stops,
                    lengths=lengths)

    def embed(self, texts: Sequence[str], mel_refs: Sequence[np.ndarray]
              ) -> Dict[str, np.ndarray]:
        """The embed-only pass: teacher-forced on the reference mels
        themselves (padded to a multiple of 64 frames), which are also both
        style references; returns the reference encoders' embeddings of the
        references and of the output mel, [B, 128] each (under emt_attn the
        emotion reference's mean [B, V] and the output mel's sequence [B,
        T', V], as JAX's); None where the model has no such encoder
        (emt_only's speaker, AdaIN's emotion and both output ones). Under
        style_tokens the decode queries with label 0, as JAX's `embed`."""
        refs = self._pad_refs(mel_refs)
        out, _ = self._gta_pass(texts, refs, refs, refs,
                                synth_embeddings=True)
        return {k: None if out.get(v) is None else out[v].cpu().numpy()
                for k, v in (
            ("emb_emt", "refnet_out_emt"), ("emb_spk", "refnet_out_spk"),
            ("emb_mo_emt", "refnet_out_mel_emt"),
            ("emb_mo_spk", "refnet_out_mel_spk"))}

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
        os.makedirs(os.path.join(eval_dir, "plots"), exist_ok=True)
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
            plot_alignment(result["alignments"][i], os.path.join(
                eval_dir, "plots", f"alignment-eval-{i}.png"), title=text)
            plot_spectrogram(mel, os.path.join(
                eval_dir, "plots", f"mel-eval-{i}.png"), title=text)
    map_path = os.path.join(eval_dir, "map.txt")
    with open(map_path, "w", encoding="utf-8") as f:
        f.write("\n".join(map_rows) + "\n")
    log(f"wrote eval synthesis for {len(sentences)} sentences -> {eval_dir}")
    return map_path


def run_gta_synthesis(synth: TacotronSynthesizer, metadata_path: str,
                      output_dir: str, batch_size: int = 32,
                      limit: Optional[int] = None) -> str:
    """Teacher-forced GTA mels for a corpus's train.txt rows, in batches of
    `batch_size`: <output_dir>/gta/mels/gta-<mel name> and a map.txt of
    rows `audio|gt_mel|gta_mel|time_steps|text` (the reference's
    tacotron_output/gta/map.txt, which WaveNet synthesis and training
    read). Returns the path of map.txt."""
    gta_dir = os.path.abspath(os.path.join(output_dir, "gta"))
    os.makedirs(os.path.join(gta_dir, "mels"), exist_ok=True)
    data_dir = os.path.abspath(os.path.dirname(metadata_path))
    with open(metadata_path, encoding="utf-8") as f:
        meta = [line.strip().split("|") for line in f if line.strip()]
    if limit:
        meta = meta[:limit]
    map_rows = []
    for start in range(0, len(meta), batch_size):
        rows = meta[start:start + batch_size]
        texts = [r[7] for r in rows]
        mels = [np.load(os.path.join(data_dir, r[0], "mels", r[2]))
                for r in rows]
        result = synth.synthesize(texts, mels, mels, mel_targets=mels,
                                  gta=True)
        for r, mel_out in zip(rows, result["mels"]):
            out_path = os.path.join(gta_dir, "mels", f"gta-{r[2]}")
            np.save(out_path, mel_out, allow_pickle=False)
            audio_path = os.path.join(data_dir, r[0], "audio", r[1])
            gt_mel_path = os.path.join(data_dir, r[0], "mels", r[2])
            map_rows.append(f"{audio_path}|{gt_mel_path}|{out_path}|{r[5]}|"
                            f"{r[7]}")
        log(f"GTA synthesis {min(start + batch_size, len(meta))}/{len(meta)}")
    map_path = os.path.join(gta_dir, "map.txt")
    with open(map_path, "w", encoding="utf-8") as f:
        f.write("\n".join(map_rows) + "\n")
    log(f"wrote GTA map -> {map_path}")
    return map_path


def _read_meta(path: str) -> List[List[str]]:
    with open(path, encoding="utf-8") as f:
        return [line.strip().split("|") for line in f
                if line.strip() and not line.startswith("#")]


def _resolve_refs(meta: List[List[str]], input_dir: str,
                  flip_spk_emt: bool = False):
    """Per-row texts, own mel paths, emotion and speaker reference mel
    paths, output basenames and labels of a synthesis metadata file: the
    train.txt schema with two columns appended, [12] the emotion reference
    and [14] the speaker reference, each 'same' (the row's own mel) or
    'dataset/mel-file.npy'; [13] tags the basename. `flip_spk_emt` swaps
    the two reference lists."""
    texts, mel_paths, refs_emt, refs_spk, basenames = [], [], [], [], []
    emt_labels, spk_labels = [], []
    for m in meta:
        own = os.path.join(input_dir, m[0], "mels", m[2])
        texts.append(m[7])
        mel_paths.append(own)

        def ref_path(spec):
            if spec == "same":
                return own
            ds, _, fname = spec.partition("/")
            return os.path.join(input_dir, ds, "mels", fname)

        refs_emt.append(ref_path(m[12] if len(m) > 12 else "same"))
        refs_spk.append(ref_path(m[14] if len(m) > 14 else "same"))
        ref_tag = m[13] if len(m) > 13 else "same"
        basenames.append(f"{m[10].split('.')[0]}_{ref_tag}")
        emt_labels.append(int(m[8]))
        spk_labels.append(int(m[9]))
    if flip_spk_emt:
        refs_emt, refs_spk = refs_spk, refs_emt
    return (texts, mel_paths, refs_emt, refs_spk, basenames, emt_labels,
            spk_labels)


def _synthesize_and_save(synth: TacotronSynthesizer, texts, refs_emt,
                         refs_spk, mel_path, wav_path, batch_size: int,
                         save_wavs: bool = True, on_batch=None,
                         align_path=None):
    """Synthesize `texts` with the reference mels at the given paths in
    batches, saving mel i to mel_path(i), its Griffin-Lim wav to
    wav_path(i) and, with `align_path`, its alignment plot to
    align_path(i); on_batch(start, end, result) runs after each batch."""
    sr = synth.cfg.audio.sample_rate
    for start in range(0, len(texts), batch_size):
        sl = slice(start, start + batch_size)
        result = synth.synthesize(texts[sl],
                                  [np.load(p) for p in refs_emt[sl]],
                                  [np.load(p) for p in refs_spk[sl]])
        wavs = synth.mels_to_wavs(result["mels"]) if save_wavs else []
        for j, mel in enumerate(result["mels"]):
            np.save(mel_path(start + j), mel, allow_pickle=False)
            if save_wavs:
                host_audio.save_wav(wavs[j], wav_path(start + j), sr)
                if align_path is not None:
                    plot_alignment(result["alignments"][j],
                                   align_path(start + j),
                                   title=texts[start + j])
        if on_batch:
            on_batch(start, start + len(result["mels"]), result)


def run_style_transfer(synth: TacotronSynthesizer, synth_metadata_path: str,
                       input_dir: str, output_dir: str, *,
                       flip_spk_emt: bool = False, batch_size: int = 16,
                       save_wavs: bool = True,
                       limit: Optional[int] = None) -> str:
    """The 'synthesis' mode: each row's text with its emotion and speaker
    references (`_resolve_refs`) -> <output_dir>/natural/{mels/mel-<base>.npy,
    wavs/wav-<base>.wav} and a map.txt of rows
    `mel_path|text|emt_label|spk_label`. Returns the path of map.txt."""
    synth_dir = os.path.abspath(os.path.join(output_dir, "natural"))
    for sub in ("mels", "wavs", "plots"):
        os.makedirs(os.path.join(synth_dir, sub), exist_ok=True)
    meta = _read_meta(synth_metadata_path)
    if limit:
        meta = meta[:limit]
    (texts, _, refs_emt, refs_spk, basenames, emt_labels,
     spk_labels) = _resolve_refs(meta, input_dir, flip_spk_emt)
    a = synth.cfg.audio
    hours = sum(int(m[6]) for m in meta) * a.effective_hop / a.sample_rate \
        / 3600
    log(f"style-transfer synthesis: {len(meta)} rows ({hours:.2f} h)")
    mel_path = lambda i: os.path.join(synth_dir, "mels",
                                      f"mel-{basenames[i]}.npy")
    map_rows = []

    def on_batch(start, end, _):
        map_rows.extend(f"{mel_path(i)}|{texts[i]}|{emt_labels[i]}|"
                        f"{spk_labels[i]}" for i in range(start, end))
        log(f"style transfer {end}/{len(texts)}")

    _synthesize_and_save(
        synth, texts, refs_emt, refs_spk, mel_path,
        lambda i: os.path.join(synth_dir, "wavs", f"wav-{basenames[i]}.wav"),
        batch_size, save_wavs, on_batch,
        lambda i: os.path.join(synth_dir, "plots",
                               f"alignment-{basenames[i]}.png"))
    map_path = os.path.join(synth_dir, "map.txt")
    with open(map_path, "w", encoding="utf-8") as f:
        f.write("\n".join(map_rows) + "\n")
    return map_path


def run_synthesis_random(synth: TacotronSynthesizer, train_txt: str,
                         input_dir: str, output_dir: str, *,
                         n_per_emotion: int = 5, paired: bool = False,
                         emt_dataset: Optional[str] = None, seed: int = 2,
                         batch_size: int = 16) -> str:
    """The 'synthesis_random' mode: per emotion class (the emt_label
    column; only the first with `paired`) `n_per_emotion` rows chosen by a
    numpy RNG seeded with `seed`, each synthesized with a random
    same-emotion reference (its own mel with `paired`) and its own mel as
    the speaker reference -> <output_dir>/random/{mel,wav}-<base>.* and a
    meta.csv of what was used. Returns the directory."""
    rng = np.random.default_rng(seed)
    synth_dir = os.path.join(output_dir, "random")
    os.makedirs(synth_dir, exist_ok=True)
    emt_rows: Dict[int, list] = {}
    for m in _read_meta(train_txt):
        if emt_dataset is None or m[0] == emt_dataset:
            emt_rows.setdefault(int(m[8]), []).append(m)
    n_emt = 1 if paired else len(emt_rows)
    texts, refs_emt, refs_spk, basenames = [], [], [], []
    meta_rows = ["basename,text,emt_label,spk_label,ref_mel"]
    for emt in sorted(emt_rows)[:n_emt]:
        rows = emt_rows[emt]
        for ci in rng.choice(len(rows), min(n_per_emotion, len(rows)),
                             replace=False):
            row = rows[ci]
            own = os.path.join(input_dir, row[0], "mels", row[2])
            if paired:
                ref = own
            else:
                ref_row = rows[int(rng.choice(len(rows)))]
                ref = os.path.join(input_dir, ref_row[0], "mels", ref_row[2])
            texts.append(row[7])
            refs_emt.append(ref)
            refs_spk.append(own)
            base = f"{row[10].split('.')[0]}_e{emt}"
            basenames.append(base)
            meta_rows.append(
                f"{base},{row[7]!r},{emt},{row[9]},{os.path.basename(ref)}")
    with open(os.path.join(synth_dir, "meta.csv"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(meta_rows) + "\n")
    _synthesize_and_save(
        synth, texts, refs_emt, refs_spk,
        lambda i: os.path.join(synth_dir, f"mel-{basenames[i]}.npy"),
        lambda i: os.path.join(synth_dir, f"wav-{basenames[i]}.wav"),
        batch_size)
    log(f"random-experiment synthesis: {len(texts)} samples -> {synth_dir}")
    return synth_dir


# VCTK accent display names (the reference's tacotron/synthesize.py:264-265)
ACCENT_NAMES = ["American", "Australian", "Canadian", "English", "Indian",
                "Irish", "NewZealand", "NorthernIrish", "Scottish",
                "SouthAfrican", "Welsh"]


def run_synthesis_multiple(synth: TacotronSynthesizer, train_txt: str,
                           input_dir: str, output_dir: str, *,
                           accents: Optional[Sequence[int]] = None,
                           n_spk_per_accent: int = 2, n_text_per_spk: int = 5,
                           min_frames: int = 200, seed: int = 0,
                           flip_spk_emt: bool = False, batch_size: int = 16,
                           acc_names: Optional[Sequence[str]] = None) -> str:
    """The 'synthesis_multiple' mode (accents crossed): among rows longer
    than `min_frames`, per accent group (the emt_label column; the first
    two unless `accents` names them) `n_spk_per_accent` speakers and per
    speaker `n_text_per_spk` texts, chosen by a numpy RNG seeded with
    `seed`; each text is synthesized once per chosen accent with a random
    utterance of that accent as the emotion reference and its own mel as
    the speaker reference (swapped by `flip_spk_emt`) ->
    <output_dir>/multiple/{mels,wavs}/. Returns the directory."""
    acc_names = ACCENT_NAMES if acc_names is None else acc_names
    rng = np.random.default_rng(seed)
    synth_dir = os.path.abspath(os.path.join(output_dir, "multiple"))
    for sub in ("mels", "wavs"):
        os.makedirs(os.path.join(synth_dir, sub), exist_ok=True)
    by_acc: Dict[int, list] = {}
    for m in _read_meta(train_txt):
        if int(m[6]) > min_frames:
            by_acc.setdefault(int(m[8]), []).append(m)
    if accents is None:
        accents = sorted(by_acc)[:2]
    accents = [a for a in accents if a in by_acc]

    def _name(a: int) -> str:
        return acc_names[a][:2] if a < len(acc_names) else str(a)

    texts, refs_emt, refs_spk, basenames = [], [], [], []
    for acc in accents:
        rows = by_acc[acc]
        spks = sorted({int(m[9]) for m in rows})
        for spk in rng.choice(spks, min(n_spk_per_accent, len(spks)),
                              replace=False):
            spk_rows = [m for m in rows if int(m[9]) == int(spk)]
            for ti in rng.choice(len(spk_rows),
                                 min(n_text_per_spk, len(spk_rows)),
                                 replace=False):
                row = spk_rows[int(ti)]
                own = os.path.join(input_dir, row[0], "mels", row[2])
                for acc_ref in accents:
                    ref_row = by_acc[acc_ref][
                        int(rng.choice(len(by_acc[acc_ref])))]
                    texts.append(row[7])
                    refs_spk.append(own)
                    refs_emt.append(os.path.join(input_dir, ref_row[0],
                                                 "mels", ref_row[2]))
                    sex = row[11] if len(row) > 11 else ""
                    basenames.append(f"{row[10].split('.')[0]}_{_name(acc)}"
                                     f"_{sex}_{_name(acc_ref)}")
    if flip_spk_emt:
        refs_emt, refs_spk = refs_spk, refs_emt
    log(f"synthesis_multiple: {len(texts)} samples ({len(accents)} accents "
        f"x {n_spk_per_accent} spk x {n_text_per_spk})")
    _synthesize_and_save(
        synth, texts, refs_emt, refs_spk,
        lambda i: os.path.join(synth_dir, "mels", f"mel-{basenames[i]}.npy"),
        lambda i: os.path.join(synth_dir, "wavs", f"wav-{basenames[i]}.wav"),
        batch_size, on_batch=lambda _, end, __: log(
            f"synthesis_multiple {end}/{len(texts)}"))
    return synth_dir


def run_style_embs(synth: TacotronSynthesizer, train_txt: str, input_dir: str,
                   output_dir: str, *, n_spk: int = 8, n_per_spk: int = 8,
                   seed: int = 0, batch_size: int = 16) -> str:
    """The 'style_embs' mode: `n_spk` speakers and `n_per_spk` utterances
    each, chosen by a numpy RNG seeded with `seed`, through `embed` ->
    <output_dir>/embeddings/{emb_emt.tsv, emb_spk.tsv} (the references'
    embeddings, then the output mels') and meta.tsv labelling the rows
    real / synth. Returns the directory. Under AdaIN (no emotion
    embedding) and emt_attn (the output mel's emotion embedding is a
    sequence) it raises ValueError, where the JAX `run_style_embs` fails
    writing the table."""
    gst = synth.cfg.gst
    if gst.adain or gst.emt_attn:
        raise ValueError(
            "style_embs under " + ("gst.adain: the model has no emotion "
                                   "embedding" if gst.adain else
                                   "gst.emt_attn: the output mel's emotion "
                                   "embedding is a sequence")
            + "; the JAX run_style_embs fails writing emb_emt.tsv there too")
    rng = np.random.default_rng(seed)
    emb_dir = os.path.join(output_dir, "embeddings")
    os.makedirs(emb_dir, exist_ok=True)
    by_spk: Dict[int, list] = {}
    for m in _read_meta(train_txt):
        by_spk.setdefault(int(m[9]), []).append(m)
    spk_ids = sorted(by_spk)
    rows = []
    for sid in sorted(rng.choice(spk_ids, min(n_spk, len(spk_ids)),
                                 replace=False)):
        cand = by_spk[sid]
        for ci in rng.choice(len(cand), min(n_per_spk, len(cand)),
                             replace=False):
            rows.append(cand[int(ci)])
    embs = {k: [] for k in ("emb_emt", "emb_spk", "emb_mo_emt",
                            "emb_mo_spk")}
    for start in range(0, len(rows), batch_size):
        batch = rows[start:start + batch_size]
        out = synth.embed([m[7] for m in batch],
                          [np.load(os.path.join(input_dir, m[0], "mels",
                                                m[2])) for m in batch])
        for k, v in out.items():
            if v is not None:
                embs[k].append(v)
    for name, real, syn in (("emb_emt.tsv", "emb_emt", "emb_mo_emt"),
                            ("emb_spk.tsv", "emb_spk", "emb_mo_spk")):
        if not embs[real]:
            continue
        np.savetxt(os.path.join(emb_dir, name),
                   np.vstack(embs[real] + embs[syn]), delimiter="\t",
                   fmt="%.6f")
    lines = ["dataset\tmel_filename\tmel_frames\temt_label\tspk_label\t"
             "basename\tsex\treal"]
    for tag in ("real", "synth"):
        for m in rows:
            lines.append("\t".join([m[0], m[2], m[6], m[8], m[9], m[10],
                                    m[11] if len(m) > 11 else "", tag]))
    with open(os.path.join(emb_dir, "meta.tsv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    log(f"style embeddings for {len(rows)} utterances -> {emb_dir}")
    return emb_dir
