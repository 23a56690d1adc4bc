"""Tacotron-2 with GST style conditioning (PyTorch).

Counterpart of tacotron2_tpu/models/tacotron/model.py. For synthesis:
`synthesis_memory_ext` (:255) — character embedding, conv + zoneout-BiLSTM
encoder, both reference encoders, GST multi-head style attention, the
style embedding's join to the encoder states and the attention keys — and
`postnet_pass` (:278); the
autoregressive decode between them is `models/tacotron/decoder.py` / the
CUDA decode kernel. `gta_pass` is `Tacotron.__call__` (:287) with
train=False, gta=True: the same memory pass, the teacher-forced decode the
caller hands in, the postnet, and with `synth_embeddings` the reference
encoders run on the output mel. `forward` is `__call__` (:287-352) for
training and its natural eval: the same passes in train mode (dropout,
zoneout, BatchNorm on batch statistics), the teacher-forced decode with
scheduled-sampling coins, and the style classifier heads.

The decoder's parameters live in `Decoder` (flax layout and names,
decoder/cell/...), the attention's memory layer among them. Ported: the
GST family (`gst.use_gst`) and without GST (`use_gst=False`, the `paper`
preset: the raw reference embeddings join the encoder states), each with
two reference encoders or, with `emt_only`, the emotion one alone; the
`Tacotron_emt_attn` variant (`gst.emt_attn`, the three `emt_attn_type`s
and `emt_ref_gru` modes), whose emotion reference encoder returns a
sequence that the decoder attends over and whose mean feeds the style
attention (JAX model.py:174-277); AdaIN (`gst.adain`: one reference
encoder, `ReferenceEncoderAdaIn`, whose speaker embedding is the style, no
GST and no style heads, JAX :93-96,177-179); `gst.se_concat` either way
(the JAX model never reads it and always concatenates, :219-223); the
mel -> linear CBHG head of `predict_linear` in the train and eval
forwards (not GTA, :331-335); the `style_disc_emt` /
`style_disc_spk` heads of `use_style_emb_disc`; the fork's training
heads: the adversarial heads (`adv_emb_disc`, through `flip_gradient`),
the unpaired second pass (`forward(use_unpaired=True)`), the frozen
pretrained classifiers (`pretrained_emb_disc`) or the style path that
bypasses GST (`pretrained_emb_disc_all`), and nat-GAN's encoder and heads
(`nat_gan`). Under emt_attn GTA, `embed` and both forwards run the plain
teacher-forced decode with the emotion memory and return its alignments
(`alignments_emt`), where the JAX package takes its XLA scan. Refused, with
ValueError: AdaIN together with emt_attn (the JAX model then builds no
emotion memory and decodes without it), and the unpaired pass under
emt_attn wherever the JAX model cannot run it either (`_check_unpaired_
emt`).
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
from torch import nn

from ...config import Config
from ...ops.grad_reversal import flip_gradient
from ...text.symbols import symbols
from .decoder import (Decoder, drop_masks, emt_context_width, emt_operands,
                      kernel_prenet, ref_rows, round_bf16, teacher_forced,
                      teacher_forced_route, teacher_forced_train,
                      teacher_inputs, zoneout_masks)
from .modules import (CBHG, REF_EMB, BiLSTMEncoder, Dense, EncoderConvStack,
                      MultiheadStyleAttention, Postnet, ReferenceEncoder,
                      ReferenceEncoderAdaIn, clear_live)


class Tacotron(nn.Module):
    """Tacotron-2 with style conditioning; weights come from `convert.py`
    (`tacotron_from_flax`, `init_tacotron`). `emt_only`, `adv_emb_disc`,
    `nat_gan`, `pretrained_emb_disc` and `pretrained_emb_disc_all` mirror
    the flax attributes (no speaker reference encoder; the adversarial,
    nat-GAN and pretrained heads); the module holds the parameters that
    the flax train forward with `use_unpaired` creates (the pretrained
    classifiers only run on the unpaired pass)."""

    def __init__(self, cfg: Config, emt_only: bool = False, *,
                 adv_emb_disc: bool = False, nat_gan: bool = False,
                 pretrained_emb_disc: bool = False,
                 pretrained_emb_disc_all: bool = False,
                 use_unpaired: bool = False):
        super().__init__()
        tc, gst, au = cfg.tacotron, cfg.gst, cfg.audio
        if gst.adain and gst.emt_attn:
            raise ValueError("gst.adain with gst.emt_attn: the JAX model "
                             "builds no emotion memory under AdaIN")
        if gst.emt_attn and gst.emt_attn_type not in (
                "simple", "multihead", "style_tokens"):
            raise ValueError(f"emt_attn_type={gst.emt_attn_type!r}")
        self.cfg, self.emt_only = cfg, emt_only
        self.adv_emb_disc, self.nat_gan = adv_emb_disc, nat_gan
        self.pretrained_emb_disc = pretrained_emb_disc
        self.pretrained_emb_disc_all = pretrained_emb_disc_all
        # GST attention and the style heads that the flax module calls
        gst_attn = gst.use_gst and not pretrained_emb_disc_all \
            and not gst.adain
        heads = gst.use_style_emb_disc and not pretrained_emb_disc_all \
            and not gst.adain
        bf16 = tc.compute_dtype == "bfloat16"
        self.embedding = nn.Parameter(
            torch.zeros(len(symbols), tc.embedding_dim))
        self.encoder_conv = EncoderConvStack(
            tc.embedding_dim, tc.enc_conv_num_layers, tc.enc_conv_channels,
            tc.enc_conv_kernel_size, tc.batch_norm_position, bf16,
            tc.dropout_rate)
        self.encoder_lstm = BiLSTMEncoder(
            tc.enc_conv_channels, tc.encoder_lstm_units, tc.zoneout_rate)
        refs = (au.num_mels, tuple(gst.reference_filters),
                gst.reference_depth)
        if gst.adain:
            self.reference_encoder = ReferenceEncoderAdaIn(*refs)
            w_emt = 0
        else:
            self.refnet_emt = ReferenceEncoder(
                *refs, all_outputs=gst.emt_attn, emt_ref_gru=gst.emt_ref_gru)
            # the emotion embedding: under emt_attn the mean of its sequence
            w_emt = self.refnet_emt.out_width
            if not emt_only:
                self.refnet_spk = ReferenceEncoder(*refs)
        if gst.use_gst and not gst.adain:
            tok_dim = gst.style_embed_depth // gst.num_heads
            self.style_tokens_emt = nn.Parameter(
                torch.zeros(gst.num_gst, tok_dim))
            self.style_tokens_spk = nn.Parameter(
                torch.zeros(gst.num_gst, tok_dim))
        if gst_attn:
            self.gst_attn_emt = MultiheadStyleAttention(
                w_emt, tok_dim, gst.num_heads, gst.style_att_dim,
                gst.style_att_type)
            if not emt_only:
                self.gst_attn_spk = MultiheadStyleAttention(
                    REF_EMB, tok_dim, gst.num_heads, gst.style_att_dim,
                    gst.style_att_type)
            style_width = gst.num_heads * tok_dim
            style_width *= 1 if emt_only else 2
        elif gst.adain:
            style_width = REF_EMB
        else:
            style_width = w_emt + (0 if emt_only else REF_EMB)
        enc_width = 2 * tc.encoder_lstm_units
        self.memory_width = enc_width + style_width
        E = emt_context_width(cfg)
        if gst.emt_attn and gst.emt_attn_type != "multihead" and \
                E != w_emt * (gst.num_heads
                              if gst.emt_attn_type == "style_tokens" else 1):
            raise ValueError(
                f"emt_attn_type={gst.emt_attn_type} carries a context_emt "
                f"of {E} features (JAX emt_context_size) but the emotion "
                f"reference gives {w_emt} a position (emt_ref_gru="
                f"{gst.emt_ref_gru!r}): they must agree")
        self.decoder = Decoder(cfg, self.memory_width,
                               emt_value_width=w_emt if gst.emt_attn else 0,
                               ref_width=ref_rows(cfg, emt_only))
        self.postnet = Postnet(au.num_mels, tc.postnet_num_layers,
                               tc.postnet_channels, tc.postnet_kernel_size,
                               tc.batch_norm_position, bf16, tc.dropout_rate)
        self.postnet_projection = Dense(tc.postnet_channels, au.num_mels)
        if tc.predict_linear:
            self.post_cbhg = CBHG(
                au.num_mels, tc.cbhg_kernels, tc.cbhg_conv_channels,
                tc.cbhg_pool_size, (tc.cbhg_projection, au.num_mels),
                tc.cbhg_projection_kernel_size, tc.cbhg_highwaynet_layers,
                tc.cbhg_highway_units, tc.cbhg_rnn_units,
                tc.batch_norm_position)
            self.cbhg_linear_specs_projection = Dense(2 * tc.cbhg_rnn_units,
                                                      au.num_freq)
        # the flax tree holds a module's parameters only where the train
        # forward (use_unpaired as the trainer says) calls it
        if heads:
            self.style_disc_emt = Dense(w_emt, gst.n_emt)
            if not emt_only:
                self.style_disc_spk = Dense(REF_EMB, gst.n_spk)
            if adv_emb_disc:
                self.style_disc_emt_adv = Dense(w_emt, gst.n_spk)
                if not emt_only:
                    self.style_disc_spk_adv = Dense(REF_EMB, gst.n_emt)
        if heads and pretrained_emb_disc and use_unpaired:
            for name, n in (("emt", gst.n_emt), ("spk", gst.n_spk)):
                if name == "spk" and emt_only:
                    continue
                setattr(self, f"pretrained_ref_enc_{name}",
                        ReferenceEncoder(*refs))
                setattr(self, f"pretrained_ref_enc_{name}_dense",
                        Dense(REF_EMB, n))
        if nat_gan:
            self.nat_gan_enc = ReferenceEncoder(*refs)
            self.nat_gan_disc = Dense(REF_EMB, 3)
            self.nat_gan_disc_emt = Dense(REF_EMB, gst.n_emt)
            self.nat_gan_disc_spk = Dense(REF_EMB, gst.n_spk)

    @property
    def memory_layer(self):
        """The attention's memory layer (decoder/cell/attention/
        memory_layer): memory -> keys."""
        return self.decoder.attention.memory_layer

    # ------------------------------------------------------------- parts

    def encode(self, inputs, input_lengths, train: bool = False,
               generator=None):
        """Character ids [B, T_in] -> encoder states [B, T_in, 2·units]."""
        x = self.embedding[inputs.long()]
        return self.encoder_lstm(
            self.encoder_conv(x, train, generator), input_lengths, train,
            generator)

    def style_embeddings(self, ref_mel_emt, ref_mel_spk,
                         train: bool = False):
        """Reference mels -> (style embedding [B, 1, S], the emotion and the
        speaker reference encoders' embeddings [B, ·] (the speaker one None
        with emt_only), and under emt_attn the emotion reference's sequence
        `emt_memory` [B, T', V], else None) — JAX `_style_embeddings`
        (model.py:174-205): with GST each embedding queries its tokens,
        without it (or under `pretrained_emb_disc_all`, :200-205) the
        embeddings join as they are. Under AdaIN the speaker embedding of
        the AdaIN encoder is the style, and there is no emotion embedding
        (:177-179)."""
        B = ref_mel_emt.shape[0]
        if self.cfg.gst.adain:
            ref_spk = self.reference_encoder(ref_mel_spk, ref_mel_emt)
            return ref_spk[:, None, :], None, ref_spk, None
        ref_emt = self.refnet_emt(ref_mel_emt, train)
        emt_memory = None
        if self.cfg.gst.emt_attn:
            emt_memory, ref_emt = ref_emt, ref_emt.mean(1)
        ref_spk = (None if self.emt_only
                   else self.refnet_spk(ref_mel_spk, train))
        parts = []
        for ref, tokens, name in ((ref_emt, "style_tokens_emt", "emt"),
                                  (ref_spk, "style_tokens_spk", "spk")):
            if ref is None:
                continue
            if hasattr(self, f"gst_attn_{name}"):
                value = torch.tanh(getattr(self, tokens))[None].expand(
                    B, -1, -1)
                parts.append(getattr(self, f"gst_attn_{name}")(
                    ref[:, None, :], value))
            else:
                parts.append(ref[:, None, :])
        return torch.cat(parts, dim=-1), ref_emt, ref_spk, emt_memory

    def _clip(self, x):
        tc, au = self.cfg.tacotron, self.cfg.audio
        if not tc.clip_outputs:
            return x
        lo = (-au.max_abs_value if au.symmetric_mels else 0.0) \
            - tc.lower_bound_decay
        return torch.clamp(x, lo, au.max_abs_value)

    # ---------------------------------------------------------- passes

    @torch.no_grad()
    def synthesis_memory_ext(self, inputs, input_lengths, ref_mel_emt,
                             ref_mel_spk):
        """-> (keys [B,T,A], memory [B,T,M], mask [B,T] bool, emt_memory
        [B, T', V], ref_spk [B, 128]); the last two are the emt_attn
        decoder's operands (JAX model.py:245-276): emt_memory None without
        emt_attn, ref_spk None unless emt_attn without emt_only."""
        enc = self.encode(inputs, input_lengths)
        style, _, ref_spk, emt_memory = self.style_embeddings(ref_mel_emt,
                                                              ref_mel_spk)
        keys, memory, mask = self._keys_memory_mask(enc, style, input_lengths)
        feed = ref_spk if self.cfg.gst.emt_attn and not self.emt_only \
            else None
        return keys, memory, mask, emt_memory, feed

    def _keys_memory_mask(self, enc, style, input_lengths):
        """Encoder states + style -> (keys, memory, mask), as
        `_decode_pass` (:215-226) joins them."""
        B, T = enc.shape[:2]
        memory = torch.cat([enc, style.expand(B, T, style.shape[-1])], -1)
        if self.cfg.tacotron.mask_encoder:
            mask = torch.arange(T, device=enc.device)[None, :] \
                < input_lengths.to(enc.device)[:, None]
        else:
            mask = torch.ones(B, T, dtype=torch.bool, device=enc.device)
        return self.memory_layer(memory), memory, mask

    @torch.no_grad()
    def postnet_pass(self, frames):
        """Clip + postnet residual + clip -> (decoder_output, mel)."""
        dec = self._clip(frames.float())
        mel = self._clip(dec + self.postnet_projection(self.postnet(dec)))
        return dec, mel

    @torch.no_grad()
    def gta_pass(self, inputs, input_lengths, mel_targets, ref_mel_emt,
                 ref_mel_spk, decode, *, synth_embeddings: bool = False,
                 emt_labels=None):
        """The eval forward with ground-truth-aligned teacher forcing
        (JAX `Tacotron.__call__(gta=True, train=False)`, model.py:287-345):
        encoder, style embeddings, memory and keys as `_decode_pass`
        (:215-245) builds them, then `decode(keys, memory, mask, teacher,
        emt)` — the teacher-forced decode with every coin set, `teacher`
        [steps, B, mels] from the targets [B, T_out, mels], and under
        emt_attn `emt` its operands in `fused_train_dtype` (`emt_labels`
        [B] the style_tokens query's labels, 0 when None, as JAX :302-306),
        else None; it returns (frames, stop logits, alignments,
        alignments_emt or None) — then the postnet between two clips.
        Returns a dict of decoder_output and mel_outputs [B, T_out, mels],
        stop_token_prediction (logits) [B, T_out], alignments [B, T_in,
        steps], alignments_emt (None without emt_attn), refnet_out_emt /
        refnet_out_spk [B, 128] (the emotion one None under AdaIN), and
        with `synth_embeddings` refnet_out_mel_emt / refnet_out_mel_spk,
        the reference encoders on mel_outputs (:338-341; none under
        AdaIN)."""
        from ...ops import tacotron_train_kernel as tk
        r = self.cfg.tacotron.outputs_per_step
        enc = self.encode(inputs, input_lengths)
        style, ref_emt, ref_spk, emt_memory = self.style_embeddings(
            ref_mel_emt, ref_mel_spk)
        keys, memory, mask = self._keys_memory_mask(enc, style,
                                                    input_lengths)
        emt = None
        if self.cfg.gst.emt_attn:
            wd = tk.train_weight_dtype(self.cfg)
            emt = self.emt_operands(emt_memory, self._ref_spk_feed(ref_spk),
                                    emt_labels, lambda w: w.to(wd))
        frames, stops, aligns, aligns_emt = decode(
            keys, memory, mask, teacher_inputs(mel_targets, r), emt)
        dec, mel = self.postnet_pass(frames)
        out = dict(decoder_output=dec, mel_outputs=mel,
                   stop_token_prediction=stops, alignments=aligns,
                   alignments_emt=aligns_emt, refnet_out_emt=ref_emt,
                   refnet_out_spk=ref_spk)
        if synth_embeddings and not self.cfg.gst.adain:
            out.update(refnet_out_mel_emt=self.refnet_emt(mel),
                       refnet_out_mel_spk=(None if self.emt_only
                                           else self.refnet_spk(mel)))
        return out

    def _ref_spk_feed(self, ref_spk):
        """The speaker embedding that the emt_attn decoder takes (JAX
        model.py:310): the paired pass's, unless emt_only."""
        return ref_spk if self.cfg.gst.emt_attn and not self.emt_only \
            else None

    def emt_operands(self, emt_memory, ref_spk, labels, weight=lambda w: w):
        """The emt attention's operands of one decode (`decoder.emt_
        operands`) from this module's weights (`extract_emt_params_traced`,
        differentiable), `weight` applied to each weight the step loop
        multiplies; `labels` [B] the style_tokens query's emotion ids,
        zeros when None (JAX model.py:302-306)."""
        from ...ops import tacotron_train_kernel as tk
        cfg = self.cfg
        ep = tk.extract_emt_params_traced(self.decoder, cfg)
        ep = type(ep)(*[weight(v) if k in tk.EMT_MATMUL and v is not None
                        else v for k, v in ep._asdict().items()])
        if cfg.gst.emt_attn_type == "style_tokens" and labels is None:
            labels = torch.zeros(emt_memory.shape[0], dtype=torch.long,
                                 device=emt_memory.device)
        return emt_operands(ep, cfg, emt_memory, ref_spk, labels)

    # ---------------------------------------------------------- training

    def forward(self, inputs, input_lengths, mel_targets, ref_mel_emt,
                ref_mel_spk, ref_mel_up_emt=None, ref_mel_up_spk=None, *,
                teacher_forcing_ratio: float = 1.0, generator=None,
                train: bool = True, decode: str = "fused", timer=None,
                use_unpaired: bool = False, emt_labels=None):
        """The train forward (JAX `Tacotron.__call__(train=True)`,
        :287-409), or with train=False its eval forward (dropout off but the
        prenet's, zoneout the EMA mix, BatchNorm on the running
        statistics). Encoder, style embeddings, memory and keys, the
        teacher-forced decode — step t takes the target frame where its
        coin (one per step, a uniform draw below the ratio) is set, else
        its own previous frame — the postnet between two clips, with
        `predict_linear` the CBHG and its linear projection on the mel,
        clipped (:331-335), and the
        style classifier heads, with `adv_emb_disc` the adversarial ones
        through `flip_gradient`. With `use_unpaired` (:355-389) a second
        pass on the crossed references `ref_mel_up_*`: their style
        embeddings, a second teacher-forced decode with its own coins and
        masks, its postnet, and the heads on it — the pretrained
        classifiers (`pretrained_emb_disc`) or the model's own reference
        encoders and heads in eval mode on `mel_outputs_up`. With `nat_gan`
        (:391-408) the naturalness encoder in train mode on the targets,
        the outputs and the unpaired outputs, its 3-class head directly
        and its emotion and speaker heads through `flip_gradient`. The
        calls run in the flax module's order, and BatchNorm's running
        statistics move in place at each train-mode call, so that the
        eval-mode calls after them read what flax reads. Random draws
        (dropout, zoneout, coins) come from `generator`. Under emt_attn
        the decodes attend over the emotion references' sequences, the
        paired one also fed the speaker embedding, and style_tokens
        queries with `emt_labels` [B] (zeros when None), as JAX
        (:300-317, 361-364).

        In train mode `decode` is "fused" (`FusedTeacherForced`: the CUDA
        train forward and backward kernels on a CUDA device, their plain
        versions on the CPU), "autograd" (autograd through the plain
        decode, the reference the fused route is held to) or "replay" (the
        fused route's forward values with autograd's backward through the
        plain decode: the fused backward's reference on the same forward,
        for a loss whose gradient is sensitive to the forward's last
        digits, as nat-GAN's are); the eval
        forward runs the eval kernel, without gradient. Where
        `teacher_forced_route` says "plain" (smoothing, emt_attn, a prenet
        other than (P, P), which JAX scans) both take the plain decode, on
        the device of their tensors, whatever `decode` says, so no
        teacher-forced kernel launches. `timer(name)`, a
        context manager (`train/tacotron_step.py:StepTimer`), times the
        memory passes and the decodes' kernels when given.

        Returns the dict `compute_losses` reads: decoder_output,
        mel_outputs [B, T_out, mels], stop_token_prediction (logits) [B,
        T_out], alignments [B, T_in, steps], alignments_emt (None without
        emt_attn), linear_outputs [B, T_out, num_freq] with
        predict_linear, refnet_out_emt /
        refnet_out_spk [B, 128], style_emb_logit_emt / _spk (/ _emt_adv /
        _spk_adv); with use_unpaired decoder_output_up, mel_outputs_up,
        refnet_out_up_emt / _spk, style_emb_logit_up_emt / _spk,
        refnet_out_mel_up_emt / _spk, style_emb_logit_mel_out_up_emt /
        _spk; with nat_gan the dict "nat_gan" of the heads' logits, JAX's
        keys."""
        if decode not in ("fused", "autograd", "replay"):
            raise ValueError(f"decode={decode!r}")
        if use_unpaired and self.cfg.gst.emt_attn:
            self._check_unpaired_emt()
        clear_live(self)
        try:
            return self._forward(
                inputs, input_lengths, mel_targets, ref_mel_emt, ref_mel_spk,
                ref_mel_up_emt, ref_mel_up_spk, teacher_forcing_ratio,
                generator, train, decode, timer, use_unpaired, emt_labels)
        finally:
            clear_live(self)

    def _check_unpaired_emt(self):
        """ValueError where the JAX model cannot run the unpaired pass
        under emt_attn: LSTM1 takes the speaker embedding (simple,
        style_tokens; flax refuses the second pass's narrower input), or
        the model's own emotion encoder re-embeds the unpaired output
        (without `pretrained_emb_disc`: its sequence reaches a head or the
        cosine term, whose loss does not broadcast)."""
        gst = self.cfg.gst
        what = None
        if ref_rows(self.cfg, self.emt_only):
            what = ("the speaker embedding feeds LSTM1, and the JAX model's "
                    "unpaired pass feeds it none (flax refuses the narrower "
                    "kernel)")
        elif self.pretrained_emb_disc_all or (
                hasattr(self, "style_disc_emt")
                and not self.pretrained_emb_disc):
            what = ("the emotion encoder's sequence of the unpaired output "
                    "reaches a loss term that the JAX package cannot "
                    "broadcast (only pretrained_emb_disc's classifiers "
                    "re-embed it)")
        if what:
            raise ValueError(f"use_unpaired under emt_attn (emt_attn_type="
                             f"{gst.emt_attn_type}): {what}")

    def _forward(self, inputs, input_lengths, mel_targets, ref_mel_emt,
                 ref_mel_spk, ref_mel_up_emt, ref_mel_up_spk,
                 teacher_forcing_ratio, generator, train, decode, timer,
                 use_unpaired, emt_labels):
        g, one = generator, not self.emt_only
        time = timer or (lambda name: nullcontext())
        with time("memory pass forward"):
            enc = self.encode(inputs, input_lengths, train, g)
            style, ref_emt, ref_spk, emt_mem = self.style_embeddings(
                ref_mel_emt, ref_mel_spk, train)
        dec, mel, stops, aligns, aligns_emt = self._decode_pass(
            enc, style, input_lengths, mel_targets, teacher_forcing_ratio,
            g, train, decode, time,
            (emt_mem, self._ref_spk_feed(ref_spk), emt_labels))
        out = dict(decoder_output=dec, mel_outputs=mel,
                   stop_token_prediction=stops, alignments=aligns,
                   alignments_emt=aligns_emt, refnet_out_emt=ref_emt,
                   refnet_out_spk=ref_spk)
        if self.cfg.tacotron.predict_linear:
            out["linear_outputs"] = self._clip(
                self.cbhg_linear_specs_projection(self.post_cbhg(mel, train)))
        heads = hasattr(self, "style_disc_emt")
        if heads:
            out["style_emb_logit_emt"] = self.style_disc_emt(ref_emt)
            if one:
                out["style_emb_logit_spk"] = self.style_disc_spk(ref_spk)
            if self.adv_emb_disc:
                out["style_emb_logit_emt_adv"] = self.style_disc_emt_adv(
                    flip_gradient(ref_emt))
                if one:
                    out["style_emb_logit_spk_adv"] = self.style_disc_spk_adv(
                        flip_gradient(ref_spk))
        if use_unpaired:
            with time("memory pass forward"):
                style_up, up_emt, up_spk, emt_mem_up = self.style_embeddings(
                    ref_mel_up_emt, ref_mel_up_spk, train)
            dec_up, mel_up, _, _, _ = self._decode_pass(
                enc, style_up, input_lengths, mel_targets,
                teacher_forcing_ratio, g, train, decode, time,
                (emt_mem_up, None, emt_labels))
            out.update(decoder_output_up=dec_up, mel_outputs_up=mel_up,
                       refnet_out_up_emt=up_emt, refnet_out_up_spk=up_spk)
            if self.pretrained_emb_disc_all:
                out["refnet_out_mel_up_emt"] = self.refnet_emt(mel_up)
                if one:
                    out["refnet_out_mel_up_spk"] = self.refnet_spk(mel_up)
            elif heads:
                out["style_emb_logit_up_emt"] = self.style_disc_emt(up_emt)
                if one:
                    out["style_emb_logit_up_spk"] = self.style_disc_spk(
                        up_spk)
                for name in ("emt", "spk") if one else ("emt",):
                    if self.pretrained_emb_disc:
                        logit = getattr(self, f"pretrained_ref_enc_{name}_dense")(
                            getattr(self, f"pretrained_ref_enc_{name}")(mel_up))
                    else:
                        r = getattr(self, f"refnet_{name}")(mel_up)
                        out[f"refnet_out_mel_up_{name}"] = r
                        logit = getattr(self, f"style_disc_{name}")(r)
                    out[f"style_emb_logit_mel_out_up_{name}"] = logit
        if self.nat_gan:
            out["nat_gan"] = self._nat_gan_heads(
                mel_targets, mel, out.get("mel_outputs_up"), train)
        return out

    def _decode_pass(self, enc, style, input_lengths, mel_targets, ratio,
                     g, train, decode, time, emt_in):
        """Memory and keys, the teacher-forced decode with its coins and
        masks drawn from `g`, the postnet between two clips (JAX
        `_decode_pass`, :207-232) -> (decoder_output, mel_outputs, stop
        logits, alignments, alignments_emt or None). emt_in: (emt_memory,
        ref_spk feed, labels), the emt_attn decode's inputs (JAX :300-317),
        each None where it has none."""
        from ...ops import tacotron_decoder_kernel as dk
        from ...ops import tacotron_train_kernel as tk
        cfg = self.cfg
        r = cfg.tacotron.outputs_per_step
        dev = mel_targets.device
        B, T_out = mel_targets.shape[:2]
        steps = T_out // r
        with time("memory pass forward"):
            keys, memory, mask = self._keys_memory_mask(enc, style,
                                                        input_lengths)
        teacher = teacher_inputs(mel_targets, r)
        coins = (torch.rand(steps, generator=g, device=dev)
                 < ratio).to(torch.int32)
        drop = drop_masks(cfg, B, steps, g, dev)
        dp = tk.extract_params_traced(self.decoder, cfg)
        kernel = teacher_forced_route(cfg) == "kernel"
        wd = tk.train_weight_dtype(cfg)
        aligns_emt = None
        if not train:
            with torch.no_grad():
                dpw = tk.cast_params(dp, wd)
                if kernel:
                    kw = (dk.pack_weights(dpw) if dev.type == "cuda"
                          else None)
                    frames, stops, aligns = tk.teacher_forced_fwd(
                        dpw, cfg, keys, memory, mask, teacher, coins, drop,
                        kernel_weights=kw)
                else:
                    prenet, emt = self._plain_operands(
                        lambda w: w.to(wd), emt_in)
                    frames, stops, aligns, *rest = teacher_forced(
                        dpw, cfg, keys, memory, mask, teacher, coins, drop,
                        emt=emt, prenet=prenet)
                    aligns_emt = rest[0] if rest else None
        else:
            zmask = zoneout_masks(cfg, B, steps, g, dev)
            if decode == "fused" and kernel:
                frames, stops, aligns = tk.FusedTeacherForced.apply(
                    cfg, time, keys, memory, mask, teacher, coins, drop,
                    zmask, *dp)
            else:
                bf16 = wd == torch.bfloat16
                rnd = round_bf16 if bf16 else (lambda w: w)
                dpr = type(dp)(*[rnd(v) if k in tk.MATMUL and v is not None
                                 else v for k, v in dp._asdict().items()])
                prenet, emt = self._plain_operands(rnd, emt_in)
                frames, stops, aligns, res = teacher_forced_train(
                    dpr, cfg, keys, memory, mask, teacher, coins, drop,
                    zmask, bf16_inputs=bf16, emt=emt, prenet=prenet)
                aligns_emt = res.get("align_emt")
                if decode == "replay" and kernel:
                    with torch.no_grad():
                        fwd = tk.FusedTeacherForced.apply(
                            cfg, time, keys, memory, mask, teacher, coins,
                            drop, zmask, *dp)
                    frames, stops, aligns = (x + (y - x).detach() for x, y
                                             in zip((frames, stops, aligns),
                                                    fwd))
        dec = self._clip(frames)
        mel = self._clip(dec + self.postnet_projection(
            self.postnet(dec, train, g)))
        return dec, mel, stops, aligns, aligns_emt

    def _plain_operands(self, weight, emt_in):
        """The plain decode's `prenet` (None for the kernels' own, which
        DecoderParams holds) and `emt` (None without emt_attn), `weight`
        applied to each matmul weight."""
        from ...ops import tacotron_train_kernel as tk
        prenet = None
        if not kernel_prenet(self.cfg):
            prenet = tuple((weight(w), b)
                           for w, b in tk.prenet_traced(self.decoder))
        emt = None
        if self.cfg.gst.emt_attn:
            emt = self.emt_operands(*emt_in, weight)
        return prenet, emt

    def _nat_gan_heads(self, mel_targets, mel, mel_up, train):
        """nat-GAN's logits (JAX :391-408): the naturalness encoder on the
        targets, the outputs and (unpaired) the unpaired outputs, each into
        the 3-class head and, through gradient reversal, the emotion and
        speaker heads."""
        ng = {}
        for key, x in (("targets", mel_targets), ("mel_p", mel),
                       ("mel_up", mel_up)):
            if x is None:
                continue
            e = self.nat_gan_enc(x, train)
            ng[f"logits_{key}"] = self.nat_gan_disc(e)
            ng[f"logits_{key}_emt"] = self.nat_gan_disc_emt(flip_gradient(e))
            ng[f"logits_{key}_spk"] = self.nat_gan_disc_spk(flip_gradient(e))
        return ng
