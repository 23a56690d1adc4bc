#!/usr/bin/env python3
"""Run the PyTorch port's serving, Tacotron-synthesis (eval, GTA, style
modes), WaveNet-synthesis, Tacotron-training and WaveNet-training paths on
one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. the device, and its name and power limit as nvidia-smi reports them;
2. build the six CUDA sources (`csrc/decoder.cu`, `csrc/decoder_rows.cu`,
   `csrc/decoder_bwd.cu`,
   `csrc/sampler.cu`, `csrc/griffin_lim.cu`, `csrc/wavenet_train.cu`) with
   nvcc for sm_90a, in parallel;
3. load the trained r5 checkpoints (artifacts/e2e_demo_r5/*.msgpack) with
   the port's own msgpack reader and weight bridge, in the configuration
   scripts/train_e2e_demo_r5_tpu.py trained them with;
4. serve 8 held-out texts at the full default width through
   `TextToWavProgram` (memory pass → decode kernel → postnet → silence
   mask → upsample → sampler kernel with the bf16 delay cache and weights,
   the JAX program's default on an accelerator), with every kernel launch
   counter set
   to 0 just before and read just after; print the samples kept after
   trimming, their audio seconds and the realtime factor; check stop
   steps, wav lengths, finiteness, and the free-run mel against the
   ground-truth mel;
5. hold the decode kernel and the f32 and bf16 sampler kernels against
   their plain PyTorch versions on the serve run's own inputs and random
   numbers (the bf16 one also against the plain version replaying its own
   trajectory, one step at a time);
6. time them and their plain versions;
7. the quality of phase 4's served wavs, as the r5 script measures it
   (`text_to_wav_mel_corr`, `vocoder_fidelity_corr`), next to the TPU
   run's numbers in report.json;
8. Tacotron eval synthesis (`TacotronSynthesizer.synthesize` →
   `mels_to_wavs`, the decode kernel's whole-decode route and the
   Griffin-Lim kernel) of the same 8 texts: stops, alignment diagonality,
   free-run mel, a bit-exact rerun of the decode;
9. long inputs: 4 texts of more than 256 padded characters through the
   decode kernel's block route, held against the plain block decode; the
   `synthesize --mode eval` command line on a short and a long text;
10. Griffin-Lim: the kernel against its plain version (iters 0, 4, 60),
    a 440 Hz tone, and `TextToWavProgram(vocoder="griffin_lim")`;
11. time the block decode and Griffin-Lim (kernel, plain, a cuFFT
    Griffin-Lim built on torch.stft / torch.istft as the library yardstick);
12. (a) `synthesize --model Tacotron-2` of the 8 texts through `cli.main`:
    Tacotron eval, eval/map.txt, then `WaveNetSynthesizer` (f32 Gaussian
    sampler kernel) writes one wav per text, each checked for its length
    and its `vocoder_fidelity_corr` against the TPU run's; then
    `synthesize --model WaveNet` on two rows of that map;
13. (b) the mixture-of-logistics head of the `paper` preset's WaveNet
    (out_channels 30, hop 275, upsample (5, 5, 11)) with random weights
    from --seed, f32 and bf16, through `WaveNetSynthesizer` on the first 64
    frames of 8 ground-truth r5 mels; and its noise-suppressed weights;
14. (c) the categorical head (mulaw-quantize, 256 classes) alike. For (b)
    and (c), over the first 512 samples: the kernel's picks against the
    inverse-CDF picks of the plain version replaying the kernel's
    trajectory with the same uniforms (ties, where u·total lies within a
    stated fraction of a cumulative boundary, are counted and are the only
    exception), samples where picks agree, and times;
15. (h) GTA of the r5 train split: the 128 train texts with their
    ground-truth mels as targets and their first 64 frames as references,
    in batches of 32 (4 launches of the teacher-forced kernel, 448 steps),
    the GTA mel MAE against the ground truth beside the TPU run's; the
    kernel against its plain version on the first batch with the same
    dropout multipliers; kernel, plain and bound times at B=32 and the
    kernel at B=8; then `synthesize --model Tacotron-2 --mode gta --limit
    8` (GTA map, WaveNet wavs and their `vocoder_fidelity_corr`), and the
    `style_embs` and `synthesis` modes on a train.txt over the r5 mels;
16. (i) Tacotron training at the r5 script's shapes (batch 16 of the
    train split, text padded to 96, 448 steps, bf16, scheduled teacher
    forcing): kernel 4a's train mode against its plain version on the r5
    weights with the same dropout and zoneout masks and tfr-0.5 coins
    (free run, and the plain step replayed on the kernel's trajectory);
    kernel 4b against its plain version on the kernel's residuals, and
    `weight_grads` of each; one whole train step through the kernels
    against autograd through the plain decode; 32 steps from
    `init_tacotron` with every launch counter set to 0 just before and
    read just after, the loss falling, the step's time split (memory
    pass, kernel 4a, kernel 4b, weight_grads, the rest of backward, the
    optimizer); the r5 checkpoint's natural eval on the 32 held-out rows
    (masked_mel_mae beside the TPU run's); `cli train` for 3 steps;
17. (j) `Tacotron_emt_attn` eval synthesis at the full default width, on
    seeded random weights from `init_tacotron` grafted with the r5
    checkpoint's tensors where shapes agree (and LSTM1's r5 rows), of the
    8 held-out texts with their corpus references, up to 512 steps: the
    `simple` and `multihead` variants through the decode kernel's emt mode
    (block route), `style_tokens` through the plain decode (route
    "plain", as the JAX package scans it) with emotion labels. Per kernel
    variant: one 32-step block of the kernel against its plain version on
    the run's inputs (every state field, context_emt too), the run's first
    block repeated bit for bit, other emotion references (and labels)
    moving the frames; times of one 256-step block, emt and not, in turns;
    then `synthesize --mode eval --hparams gst.emt_attn=true,...` on a
    checkpoint written by `train/checkpoint.py`;
18. (k) the `paper` preset (no GST: memory 768 wide; the MoL head, bf16
    sampler) served through `TextToWavProgram` on random weights, B=2,
    t_in 64, 64 decode steps: finite wavs of mel length x hop samples, a
    bit-exact rerun, the realtime factor;
19. (l) WaveNet training at the r5 script's shapes (the `r5_config()`
    WaveNet: bf16 stack, `use_fused_train_stack`; B 16 crops of 8,000
    samples of the r5 train split's rows 0-15 with their ground-truth
    mels): kernels 5a and 5b against their plain versions on the r5 EMA
    weights with dropout from one seed (the skip sum, every gradient, the
    cosine of all of them, bit-exact reruns) and their times beside the
    plain versions', autograd of the plain stack and the bounds; 32
    `train_step`s from `init_wavenet` with every launch counter set to 0
    just before and read just after, the loss falling, the first 12
    losses against the same steps through the f32 layer loop, the step's
    time split; the r5 EMA checkpoint's `eval_step` loss on fixed crops in
    f32 and bf16 against the JAX package's values; `cli train --model
    WaveNet` for 3 steps, its checkpoint through `cli synthesize --model
    WaveNet`, and `cli train --model Tacotron-2` (2 steps a stage);
20. (m) the decode kernels' envelope on the r5 weights: the bf16 rounding
    repair's size on the served call's inputs (the kernel against the same
    weights without the TPU kernels' roundings); f32 decode weights
    (`tacotron.fused_decoder_dtype=float32`) through eval synthesis of the
    8 texts (kernel 1 in f32 against its plain version over the first 256
    steps within 1e-4, the cell states 1e-4 of their scale, with the bf16
    kernel as a control that must fail; every stop, diagonality >=
    0.95, free-run mel >= 0.9, a bit-exact rerun, the f32-vs-bf16 mel
    difference) and the 4 long
    texts (kernel 3 in f32, one 256-step block, every state field within
    1e-4, the cell states of their scale); smoothing attention (`tacotron.smoothing=true`,
    bf16) through both routes (kernel against plain as phases 5, 9 and 17
    hold the rounded bf16 function: the plain step replayed on the
    kernel's first 256 steps; finite, a bit-exact rerun, the diagonality
    printed: r5 was trained with the softmax); f32 `TextToWavProgram`
    (Griffin-Lim) and GTA of 32
    train texts (phase 15's MAE gate); f32 train weights
    (`fused_train_dtype=float32`) at phase 16's shapes: kernels 4a (every
    residual within phase 16's tolerances, the cell states of their
    scale) and 4b (each gradient within
    1e-4 of its scale) against their plain versions, 8 steps from
    `init_tacotron` (finite, falling, the step's split), the r5 held-out
    eval through kernel 4a's eval mode in f32 (masked_mel_mae <= 0.0235);
    4 smoothing train steps through the plain route with no teacher-forced
    launch; `synthesize`, `serve` and `train` on the command line with the
    flags;
21. (n) the WaveNet stack kernels' envelope: f32 weights (the default
    `wavenet.compute_dtype`) with bf16 and with f32 saved activations at
    phase 19's shapes on the r5 EMA weights: kernels 5a and 5b against
    their plain versions (the skip sum within 1e-5 of max(1, its max),
    each gradient within 1e-4 of its max), with phase 19's bf16 kernel on
    the same inputs as a control that must fail that gate, bit-exact
    reruns, times beside the plain versions' and the 3xTF32 bounds; four
    width sets (the r5 widths, 20 layers; R 8 G 16 S 8 cin 10; R 24 G 40
    S 16 cin 12; R 256 G 512 S 256 cin 80, 20 layers) at B 4 x 2,000
    samples in both weight types on random weights (the f32 gate, or
    phase 19's bf16 gates on the largest differences and the cosine, its
    mean share printed); 8 f32 train steps from
    `init_wavenet` with the launch counters zeroed just before and read
    just after (8 and 8), the loss falling and within phase 19's 1e-2 of
    the f32 layer loop's, the step's split; `fused_stack_apply` with f32
    saved activations through autograd twice; one `paper` preset train
    step; `cli train --model WaveNet` at the default dtype for 3 steps and
    its checkpoint through `cli synthesize --model WaveNet`;
22. (o) the redesigned kernels' other routes and shapes: the Griffin-Lim
    DFT route (a non-power-of-two n_fft, 1,000) against its plain version
    as phase 10 holds the FFT route, with its times; the sampler at B=1,
    16 and 32 (1, 2 and 4 clusters, each on the serve call's rows over its
    own window of samples) against its plain version (f32 within
    SAMPLER_F32_ATOL, bf16 by phase 5's replay gate), each row bit for bit
    the B=8 run's on its window; the Griffin-Lim launches by route on the eval
    and Griffin-Lim serving paths (FFT only at n_fft 2,048);
23. (p) the serve decode kernel (`csrc/decoder_rows.cu`, one cluster for 8
    rows) at B=1, 9 and 16 on rows of the serve call: each held against
    its plain version by phase 5's replay gate and, row for row, bit for
    bit the B=8 run's; `WaveNetSynthesizer` at R 120, which the sampler
    kernel refuses, sampling through the plain version on the card;
24. (q) kernel 4a (`csrc/decoder_rows.cu`'s teacher-forced mode, which
    phases 15, 16 and 20 reach) at B=32, 16, 9 and 1 on the r5 weights and
    the first 32 train texts at phase 16's shapes, with mixed coins: the
    train mode against its plain version by phase 16's gates (free run and
    the plain step replayed on the kernel's trajectory), the eval mode by
    phase 15's shares and mean, each rerun bit for bit and every row bit
    for bit the B=32 launch's;
25. (r) kernels 5a and 5b (`csrc/wavenet_train.cu`, a wgmma mainloop fed by
    a TMA ring) at B=1, 3 and 32 (N = B·1,007 rows, not a multiple of the
    128-row tile) on the r5 EMA weights in both weight types: phase 19's
    bf16 gates and phase 21's f32 gate against the plain versions, reruns
    bit for bit, the kernel launches a layer (a pre-pass and one a layer
    forward; at most 4 a layer backward), and each launch kind's device
    time at phase 19's shapes under torch.profiler;
26. (s) the fork's Tacotron training modes at phase 16's shapes on a
    train.txt over the r5 corpus's 128 train rows with synthetic labels
    (emotion i mod 4, speaker (i // 4) mod 8, emt4 on even rows), the r5
    weights and seeded new heads: with the unpaired/intercross pass, the
    adversarial heads, nat-GAN, the refnet optimizer and the pretrained
    classifiers all on, 8 nat-GAN discriminator-pretraining steps on one
    batch (its 3-class loss falling, only nat-GAN's tensors moving, the
    step at 0), then 8 feeder steps (every term finite, each optimizer
    moving its masked tensors, the pretrained ones held, kernel 4a
    launching 2 times and 4b 4 times a step, counted by the wrappers and
    held against torch.profiler's launches by kernel name), the step's
    time and split beside phase 16's; one step's three gradients in f32
    through the fused route against autograd's backward on the same
    forward values within 1e-4 of each one's largest magnitude (against
    autograd through the plain decode printed beside); `emt_only` and the
    `paper` preset's Tacotron from a fresh init, 8 steps on one batch, the
    loss falling;
27. (t) the style discriminators (`disc/`) at the r5 config's full width
    over phase 26's train.txt: `cli disc-train` 200 steps of an emotion
    CE and a speaker GE2E discriminator (the loss finite and its last 20
    steps' mean below its first 20's: the labels are synthetic and carry
    no signal, so this shows only that the rows are memorized), one CE
    step on the card against the same step on the CPU (embeddings,
    gradients, statistics and the updated parameters within the
    tolerances stated at DISC_EMB_ATOL, at most DISC_FLIP_SHARE of a
    tensor's elements exempt as sign flips),
    `cli emt-disc-train` for 40 steps with its val line every 10, `cli
    disc-preprocess` of the r5 audio of rows 0-15 written as wavs of two
    speakers and `disc-train --stacks-dir` on its stacks for 50 steps;
    `cli train --unpaired --pretrained-emb-disc` with both
    discriminators grafted for 4 steps, with `--save-output-vars` and a
    torch.profiler window over steps 3-4 (the grafted encoders and
    statistics bit for bit the discs' at the graft and at step 4;
    4a and 4b counted by the wrappers, 2 each a step, and equal to the
    trace's launches by kernel name; metrics.jsonl, train.log, the step-1
    output vars); `cli synthesize --mode synthesis` of 16 rows on kernel 1
    classified by `cli disc-test` (its predictions equal the same
    checkpoint's `disc-test --device cpu` row for row, acc the confusion
    matrix's trace over 16, 16 rows in it and in the CSV, the plot skipped
    with a logged line where matplotlib is missing); `overfit` of 8 r5 rows for 20 steps,
    the loss falling;
28. (u) the Tacotron variants the port once refused, at the r5 widths in
    bf16 compute on init_tacotron weights (seeded) grafted with the r5
    checkpoint's where path and shape agree: AdaIN with se_concat=False
    (memory 640 wide) synthesizes the 8 texts through the rows kernel
    (held against its plain version by phase 5's replay gate), trains 3
    steps at phase 16's shapes through kernels 4a and 4b (the wrappers'
    counts equal to torch.profiler's) and holds one f32 step's fused
    gradient against decode="replay" at phase 26's 1e-4; predict_linear
    trains 4 steps on a batch with seeded linear targets [B, T_out, 1025]
    (the linear loss finite and falling); emt_attn simple, multihead and
    style_tokens train 2 steps on the plain route (no 4a/4b launch by the
    counters or the trace) and run GTA and `embed` of the 8 texts, held in
    f32 against the same computation on the CPU; prenets (256, 128) and
    (256, 256, 256) synthesize the 8 texts and train 2 steps on the plain
    route (no decode-kernel launch), the frames held in f32 against the
    CPU's; each route printed;
29. (v) the WaveNet variants at the r5 widths (bf16 stack) on seeded
    `init_wavenet` weights grafted with the r5 EMA checkpoint's where path
    and shape agree: the 1D, 2D, Resize and NearestNeighbor upsamples
    (each upsample on the card against the CPU's in f32; 2 train steps at
    phase 19's shapes through kernels 5a and 5b, the wrappers' and the C
    side's counts against torch.profiler's; 512 samples of 8 rows through
    the bf16 sampler kernel held by phase 5's replay gate), the Resize
    vocoder serving the 8 held-out texts through `TextToWavProgram`;
    global conditioning (16 channels, 4 speakers: 2 steps on the layer
    loop with no stack launch, the speaker-embedding export, sampling
    through the kernel without the speaker, as the JAX synthesizer does);
    kernel_size 2 (2 layer-loop steps, the plain sampler on the card
    against the CPU's replay); cin_channels -1 (2 steps; the synthesizer
    raises); then `cli create-metadata`, `preprocess` and
    `wavenet-preprocess` of 16 r5 wavs and `cli train --model WaveNet`
    (1D upsample) for 3 steps on the map.txt; each route printed;
30. (w) data parallelism (`tacotron2_tpu_torch/parallel/`): (a) an nccl
    group of one rank in this process, a bf16 Tacotron step and a WaveNet
    step through the data-parallel trainers against the plain ones; (b)
    two gloo ranks spawned on the one card (nccl refuses two ranks on one
    device), each from the r5 checkpoints: 2 Tacotron steps on 8 of 16
    train rows a rank (each padded to its own longest; the group pads to
    the global batch's) in bf16 and in f32 compute, 2 WaveNet steps from
    init_wavenet on 8 of phase 19's 16 crops at dropout 0, the serving
    program's sharded
    call over the 8 held-out texts (4 a rank) and the sharded sampler on
    phase 5's [8, 512] window; each held against the one-process run on
    the card that this process makes meanwhile (f32 terms 1e-5 of
    themselves, bf16 1e-3 of the step's loss as phase 16's whole-step
    gate, the program and sampler bit for bit), the ranks' parameters bit
    for bit alike, the launches of 4a/4b, 5a/5b and kernels 1 and 2
    counted on each rank and those of 1 and 2 equal to the one-process
    program's; a rank that fails or outlives
    DP_TIMEOUT_S fails the phase. Its times are of two ranks sharing one
    card, no scaling figure;
31. (x) tensor parallelism and the long tail: (a) a (data 2 × model 2)
    gloo group of four processes spawned on the card, each from the r5
    checkpoints: the sharded r5 EMA WaveNet's f32 eval forward (the
    channel-split layer loop) on 10-frame crops of phase 19's 16 rows, 2
    bf16 and 2 f32 TP train steps from init_wavenet (kernels 5a/5b on
    weights gathered over 'model', on each data shard's 8 rows) and a
    bf16 Tacotron step on 8 of phase 30's 16 rows a data shard (kernels
    4a/4b), each held against the one-process run this process makes
    meanwhile at phase 30's gates, the forward within TP_FWD_RTOL, every
    process's gathered state bit for bit alike, the launches counted on
    each process (the kernels line's `launches_phase31_per_process`);
    (b) Griffin-Lim's bf16 mode on the FFT route (n_fft 2,048) and the DFT
    route (n_fft 1,000) on [8, 321, 1025] x 60 from a seeded random-phase
    start: against the route's plain version, which rounds where the
    route does (`griffin_lim_fft_plain` / `griffin_lim_plain`, bf16), at
    0 iterations within GL_BF16_ITER0_RTOL of the peak and at 1 within
    GL_BF16_ITER1_MED (median error), and more than GL_BF16_APART times
    those gates away from the f32 kernel at both; at 60 within
    GL_BF16_F32_DRIFT of the f32 kernel's spectral consistency (JAX's own
    bound); timed beside the f32 kernel and cuFFT, launched once through
    `inv_mel_spectrogram(gl_compute_dtype="bfloat16")`; (c)
    `griffin_lim_tf` at 2 and 60 iterations on the card against the CPU
    (GL_TF_CPU_RTOL) and against the TF fixture at the fixture's gates
    (GL_TF_FIXTURE_RTOL); (d)
    the native data-IO runtime built by the host compiler and bit-equal to
    np.load on the 160 r5 corpus mels; (e) `cli live --pipeline` over two
    stdin lines (kernels 1 and 2 counted). Times of (a) are of four
    processes sharing one card, no scaling figure;
then the `kernels` line, one entry for every kernel, sampler head, dtype,
mode, Griffin-Lim route and WaveNet variant sampled.

The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero before it. Without a CUDA device it exits with code 2 and
prints no result.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import wave

ROOT = os.path.dirname(os.path.abspath(__file__))
R5 = os.path.join(ROOT, "artifacts", "e2e_demo_r5")
HELD_ROWS = list(range(128, 136))   # 8 of the 32 held-out utterances
T_IN, T_REF = 128, 64
# scripts/train_e2e_demo_r5_tpu.py:235-236: int(1.25 * chars_hi * frames
# per char / r) with chars_hi=80, char_dur=0.06 s, 16 kHz, hop 200, r=1
MAX_STEPS = int(1.25 * 80 * (0.06 * 16000 / 200) / 1)
SAMPLER_WINDOW = 512
# report.json's quality numbers on these rows (held-out indices 0-7)
TPU_T2W_MEAN = 0.841
TPU_VOC_MEAN = 0.843
# phase 15: the r5 script's GTA batch (--synth-batch) and train split;
# report.json's gta_mae_vs_gt, and the gate at 1.35x it
GTA_BATCH, N_TRAIN = 32, 128
TPU_GTA_MAE = 0.0146
GTA_MAE_MAX = 0.0197
# Griffin-Lim kernel vs plain on the eval batch after 4 iterations: the
# largest sample difference, and the kernel's distance from a float64
# reconstruction against the plain version's, both as root mean squares
# (PERF.md gives the readings they were set from)
GL_ITERS4_ATOL = 2e-2
GL_ITERS4_F64_RATIO = 1.5
# Sampler kernel vs the plain version. Free run, f32: the same function in
# another sum order, fed back over 512 samples. The plain version replaying
# the kernel's own trajectory, one step at a time: f32 differs in sum order
# only; bf16 also where that order moves a bf16 rounding of x or h by one
# step (~0.4% of one value). Draws of the MoL and categorical heads: in
# f32 a kernel draw may differ from the plain version's (another class, or
# a MoL sample off by more than SAMPLER_REPLAY_ATOL) only at a tie, u·total
# within SAMPLER_TIE_REL of the total from a cumulative boundary. In bf16
# a moved rounding shifts the logits further, so there at most
# SAMPLER_BF16_MOVED of the draws may differ, and no more than twice (plus
# a few) as many as differ between the plain version on the GPU and the
# same plain version on the CPU, whose sums go in yet another order. That
# the bf16 kernel computes the bf16 function, not the f32 one, phase 5
# holds on the trained Gaussian head. A bf16 free run is
# not held sample by sample: its per-step differences (~1e-4) grow through
# the fed-back noise draws as the f32 ones (~1e-7 to ~1e-4 over 512
# samples) do, to O(0.1); the replay holds each step, phase 7 the served
# wavs' quality.
SAMPLER_F32_ATOL = 1e-3
SAMPLER_REPLAY_ATOL = {"float32": 1e-3, "bfloat16": 2e-3}
SAMPLER_TIE_REL = 1e-5
SAMPLER_BF16_MOVED = 0.05
# default --seed (phases 12-14's noise, the random WaveNet weights of
# 13-14), and the frames of each ground-truth mel those vocode
SEED = 1234
HEAD_FRAMES = 64

# Published peaks of one H100 SXM at its 700 W limit, and its L2 (NVIDIA
# data sheet).
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12

# scripts/make_tiny_dataset.py:53-100 draws the corpus texts this way
ALIGN_CHARS = "abcdefghij"


def corpus_texts(n_total=160, chars=(40, 80), seed=0):
    """The texts of the r5 corpus's 160 utterances, rows 0-127 the train
    split and 128-159 the held-out ones."""
    import numpy as np
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n_total):
        n = int(rng.integers(chars[0], chars[1] + 1))
        idx = rng.integers(0, len(ALIGN_CHARS), n)
        texts.append("".join(ALIGN_CHARS[j] for j in idx))
    return texts


def held_out_texts(n_train=N_TRAIN):
    return corpus_texts()[n_train:]


def time_resample(mel, n_out):
    """scripts/train_e2e_demo_r5_tpu.py:41 — linear resample of a [T, M]
    mel onto n_out frames."""
    import numpy as np
    n_in = len(mel)
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = (pos - i0)[:, None].astype(np.float32)
    return (1.0 - w) * mel[i0] + w * mel[i1]


def r5_config():
    """The config scripts/train_e2e_demo_r5_tpu.py:117-135,142 builds:
    defaults, bf16 compute, all-VMEM sampler delay lines, and the corpus'
    audio config (trim_silence=False)."""
    from tacotron2_tpu_torch.config import Config
    cfg = Config()
    return cfg.replace(
        tacotron=dataclasses.replace(cfg.tacotron, compute_dtype="bfloat16",
                                     use_fused_train_decoder=True),
        wavenet=dataclasses.replace(cfg.wavenet, compute_dtype="bfloat16",
                                    use_fused_train_stack=True,
                                    sampler_hbm_delay_threshold=0),
        audio=dataclasses.replace(cfg.audio, trim_silence=False))


# phase 19: WaveNet training at the r5 script's shapes
# (train_e2e_demo_r5_tpu.py:63,69: --wn-batch 16, --crop 8000): B 16 crops
# of 40 frames (8,000 samples at hop 200) of the r5 train split's rows
# 0-15, their ground-truth mels as conditioning (hop-aligned, trimmed to
# n_f = min(mel frames, samples // hop) as the script trims, :270-277)
WN_ROWS = tuple(range(16))
WN_CROP_FRAMES = 40
WN_STEPS = 32
# the r5 EMA checkpoint's eval loss on the fixed crops of
# `r5_parity_batch`, computed by the JAX package on the CPU in f32 and
# with the r5 config's bf16 stack (tests/test_torch_wavenet_train.py::
# test_r5_ema_loss_matches_jax checks these values against the JAX
# model); the card's f32 eval_step is held to the first within
# R5_EMA_RTOL, its bf16 one to the second within R5_EMA_BF16_RTOL
R5_EMA_LOSS_JAX = -5.523944854736328
R5_EMA_LOSS_JAX_BF16 = -5.253201961517334
R5_EMA_RTOL = 1e-4
R5_EMA_BF16_RTOL = 5e-3
PARITY_ROWS, PARITY_START = (0, 1, 2, 3), 100


def r5_wavenet_rows(corpus, rows):
    """(audio, mel) of r5 corpus rows, trimmed to whole hops."""
    import numpy as np
    out = []
    for i in rows:
        a = np.load(os.path.join(corpus, "audio", f"audio-{i}.npy"))
        m = np.load(os.path.join(corpus, "mels", f"mel-{i}.npy"))
        n_f = min(len(m), len(a) // 200)
        out.append((a[:n_f * 200].astype(np.float32),
                    m[:n_f].astype(np.float32)))
    return out


def wavenet_batch(pairs, starts, frames=WN_CROP_FRAMES):
    """Crops of `frames` frames from the given start frames: the feeder's
    batch (x [B, T, 1], y, c clipped and rescaled to [0, 1],
    input_lengths)."""
    import numpy as np
    from tacotron2_tpu_torch.config import Config
    from tacotron2_tpu_torch.data.wavenet_feeder import interp_to_unit
    cfg = Config()
    mx, hop = cfg.audio.max_abs_value, cfg.audio.effective_hop
    xs, cs = [], []
    for (a, m), s in zip(pairs, starts):
        xs.append(a[s * hop:(s + frames) * hop])
        cs.append(interp_to_unit(np.clip(m[s:s + frames], -mx, mx), cfg))
    x = np.stack(xs).astype(np.float32)
    return dict(x=x[..., None], y=x.copy(),
                c=np.stack(cs).astype(np.float32),
                input_lengths=np.full(len(xs), frames * hop, np.int32))


def r5_parity_batch(corpus):
    """The fixed crops the r5 EMA loss is held on: rows PARITY_ROWS from
    frame PARITY_START."""
    return wavenet_batch(r5_wavenet_rows(corpus, PARITY_ROWS),
                         [PARITY_START] * len(PARITY_ROWS))


def phase(n, name):
    print(f"[phase {n}] {name}", flush=True)
    return time.time()


def done(n, t0):
    print(f"[phase {n}] {time.time() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps):
    """Median CUDA-event time of fn() in ms over `reps` runs (one warm-up
    run happened before, in the phase that checked the result)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def first_fire(stops, r, K, steps):
    """Per row: the step its sticky stop flag first fires (or None), and
    the steps every row runs under the batch-wide early-stop rule (until
    the first K-step boundary at which all rows have fired)."""
    import numpy as np
    s = stops.reshape(stops.shape[0], steps, r)
    fired = (s > 0.5).all(-1)
    first = [int(np.nonzero(row)[0][0]) if row.any() else None
             for row in fired]
    run = (steps if any(f is None for f in first)
           else min(steps, (max(first) // K + 1) * K))
    return [(f, run) for f in first]


def diagonality(a):
    """scripts/train_e2e_demo_r5_tpu.py:397-404: correlation of the
    attention's mean input position with the diagonal."""
    import numpy as np
    a = np.asarray(a, np.float64)
    a = a / np.maximum(a.sum(axis=0, keepdims=True), 1e-8)
    pos = (np.arange(a.shape[0])[:, None] * a).sum(axis=0)
    ideal = np.linspace(0, a.shape[0] - 1, a.shape[1])
    c = np.corrcoef(pos, ideal)[0, 1]
    return float(0.0 if np.isnan(c) else c)


def wav_quality(wav, free_mel, gt, audio):
    """scripts/train_e2e_demo_r5_tpu.py:410-428: the mel of the
    preemphasised, rescaled wav against the ground truth after pace
    normalisation (text_to_wav_mel_corr) and against the free-run mel that
    conditioned it (vocoder_fidelity_corr)."""
    import numpy as np
    from tacotron2_tpu_torch.data import audio as host_audio
    pre = host_audio.preemphasis(np.asarray(wav, np.float32),
                                 audio.preemphasis, audio.preemphasize)
    if audio.rescale:
        pre = pre / max(np.abs(pre).max(), 1e-9) * audio.rescaling_max
    mel_re = np.asarray(host_audio.mel_spectrogram(pre, audio))
    t2w = float(np.corrcoef(time_resample(mel_re, len(gt)).ravel(),
                            np.asarray(gt).ravel())[0, 1])
    n = min(len(mel_re), len(free_mel))
    voc = float(np.corrcoef(mel_re[:n].ravel(),
                            np.asarray(free_mel)[:n].ravel())[0, 1])
    return t2w, voc


def weight_rereads(dp, batch_steps):
    """Bytes of the decode weights that a kernel streaming them every step
    reads again from HBM after the first step: what does not fit the L2
    (the f32 weights, ~73 MB at the default width; the bf16 ones, ~36 MB,
    fit). A diagnostic of the kernels' design (each cluster streams its
    row's weights), not part of any bound: the card's on-chip storage (L2,
    shared memory and registers, ~113 MB) holds the f32 weights, so the
    function itself needs them read once."""
    w_bytes = sum(t.numel() * t.element_size() for t in dp)
    n = max(0.0, w_bytes - L2_BYTES) * max(0, batch_steps - 1)
    return (f"weights re-read past the L2 by the streaming design (not in "
            f"the bound): {n / 1e6:.1f} MB, {1e3 * n / HBM_BYTES_PER_S:.4f} "
            f"ms at the HBM rate")


def decode_bound_s(dp, cfg, B, T, M, steps_total, row_steps, align,
                   in_bytes=0, emt=None):
    """Least seconds the card could take for a decode: the larger of its
    bytes (weights, keys, memory, mask, dropout multipliers and `in_bytes`
    of other inputs read once, frames/stops and optionally alignments
    written once) over HBM and its operations (the
    products at the rate of the weights' type: bf16 on the tensor cores,
    f32 as 3xTF32 or, under emt_attn, at the f32 rate; the f32 attention at
    the f32 rate) for the
    row-steps this run's data needs (its rows step together: row_steps / B
    steps). Under emt_attn (`emt`, the call's EmtOperands) also the emt
    weights and operands read once, LSTM1's E extra rows and the scorer's
    query product (and multihead's output Dense) at the weights' rate, its
    tanh energies, softmax and contexts at the f32 rate. Returns (seconds,
    "bytes" or "operations")."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    U, P = tc.decoder_lstm_units, tc.prenet_layers[-1]
    A, KW = dp.wq.shape[1], dp.loc_k.shape[0]
    FO = r * mels + r
    w_bytes = sum(t.numel() * t.element_size() for t in dp)
    d_bytes = (w_bytes + 4 * B * T * (A + M + 1) + row_steps * 2 * P * 4
               + B * steps_total * (FO + (T if align else 0)) * 4 + in_bytes)
    # csrc/decoder_rows.cu runs f32 products as 3xTF32 (495 / 3 TFLOP/s),
    # csrc/decoder.cu's emt mode on the FP32 cores
    mm_rate = (BF16_FLOPS if dp.l1_wp.element_size() == 2 else
               F32_FLOPS if emt is not None else TF32_FLOPS / 3)
    mac_bf16 = (mels * P + P * P + (P + M + U) * 4 * U + 2 * U * 4 * U
                + U * A + (U + M) * FO)
    op_f32 = T * A * (2 * KW + 4) + 2 * T * M + 6 * T + 20 * U
    if emt is not None:
        Te, A2 = emt.ekeys.shape[1:]
        NH, V, E = emt.score.shape[0], emt.emem.shape[2], emt.l1_we.shape[0]
        d_bytes += sum(t.numel() * t.element_size() for t in emt
                       if t is not None)
        mac_bf16 += E * 4 * U + U * A2 + (0 if emt.out_w is None
                                          else NH * V * E)
        op_f32 += Te * A2 * (2 + 2 * NH) + 2 * NH * Te * V + 6 * NH * Te
    ops_s = row_steps * (2 * mac_bf16 / mm_rate + op_f32 / F32_FLOPS)
    bytes_s = d_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


def griffin_lim_flops(B, F, n_fft, win, iters):
    """Operations Griffin-Lim needs on [B, F, n_fft//2+1]: 2·iters+1
    real transforms of n_fft points a frame (2.5·n·log2(n) each, the usual
    real-FFT count), a window multiply-add over the win-sample support of
    each, and iters magnitude projections of ~8 operations a bin."""
    import math
    K = n_fft // 2 + 1
    per_frame = ((2 * iters + 1) * (2.5 * n_fft * math.log2(n_fft) + 2 * win)
                 + iters * 8 * K)
    return B * F * per_frame


def gl_magnitudes(mels, audio, device):
    """Mels [B, F, mels] -> Griffin-Lim target |S|^power [B, F, K], as
    ops/griffin_lim.py:inv_mel_spectrogram builds it."""
    import torch
    from tacotron2_tpu_torch.ops import stft as tst
    mel = torch.as_tensor(mels, device=device)
    D = tst.denormalize_db(mel, audio)
    S = tst.db_to_amp(D + audio.ref_level_db) ** (1.0 / audio.magnitude_power)
    return tst.mel_to_linear(S, audio) ** audio.power


def library_griffin_lim(S, n_fft, hop, win, iters, re0=None, im0=None):
    """The same reconstruction through cuFFT (torch.stft / torch.istft,
    librosa's centring and window-sum-square normalisation), from (re0,
    im0) or the zero-phase start, in S's dtype (float64 makes it the
    reference the f32 versions are measured against): the yardstick a later
    kernel is timed against. Never used by the port."""
    import torch
    window = torch.hann_window(win, periodic=True, device=S.device,
                               dtype=S.dtype)
    length = hop * (S.shape[1] - 1)
    St = S.transpose(1, 2)
    if re0 is None:
        re0, im0 = S, torch.zeros_like(S)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, window=window,
              center=True)
    y = torch.istft(torch.complex(re0, im0).transpose(1, 2), length=length,
                    **kw)
    for _ in range(iters):
        est = torch.stft(y, pad_mode="constant", return_complex=True, **kw)
        est = est / torch.clamp(est.abs(), min=1e-8) * St
        y = torch.istft(est, length=length, **kw)
    return y


def sampler_bound_s(sp, cfg, B, W, weight_bf16):
    """Least seconds for W samples of B rows: the larger of the bytes (the
    layer weights once in their dtype, biases and head in f32, c_up and
    the noise planes read, the samples written) over HBM and the
    operations (the layer products at the bf16 tensor-core rate for bf16
    weights, else the f32 rate; the head's products at the f32 rate; the
    draw's few operations a sample not counted). Returns (seconds, "bytes"
    or "operations")."""
    from tacotron2_tpu_torch.models.wavenet.distributions import head_kind
    wn = cfg.wavenet
    R, G, S, C, L = (wn.residual_channels, wn.gate_channels,
                     wn.skip_out_channels, wn.cin_channels, wn.layers)
    kind, planes = head_kind(cfg)
    n = lambda ts: sum(t.numel() for t in ts)
    layer_w = n([t for lp in sp.layers
                 for t in (lp.conv_w, lp.cin_w, lp.skip_w, lp.out_w)])
    layer_b = n([t for lp in sp.layers
                 for t in (lp.conv_b, lp.cin_b, lp.skip_b, lp.out_b)])
    head = n(sp[:2]) + n(sp[3:])
    w_bytes = layer_w * (2 if weight_bf16 else 4) + (layer_b + head) * 4
    d_bytes = w_bytes + B * W * (C + planes + 1) * 4
    layer_mac = L * ((3 * R + C) * G + (G // 2) * (S + R))
    head_mac = S * S + S * wn.out_channels + (R if kind != "categorical"
                                              else 0)
    ops_s = B * W * 2 * (layer_mac / (BF16_FLOPS if weight_bf16
                                      else F32_FLOPS)
                         + head_mac / F32_FLOPS)
    bytes_s = d_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


def chain_us(ms, W, cfg):
    """A sampler time over W samples as µs a sample and µs a layer: a
    diagnostic of its serial chain, not part of any bound."""
    us = 1e3 * ms / W
    return (f"{us:.2f} us a sample, {us / cfg.wavenet.layers:.3f} us a "
            f"layer")


def random_wavenet_tree(cfg, seed):
    """Random WaveNet weights for `cfg` in the flax param tree's layout
    (what `convert.wavenet_from_flax` and `extract_sampler_params` read):
    dense and conv kernels normal with std 1/sqrt(fan-in), small biases,
    the SubPixel upsample convs passing each mel value through their
    centre tap. A mixture head's means and scales are kept off the ±1
    clip; its logits, and a categorical head's, spread the picks."""
    import numpy as np
    rng = np.random.default_rng(seed)
    wn = cfg.wavenet
    R, G, S, C = (wn.residual_channels, wn.gate_channels,
                  wn.skip_out_channels, wn.cin_channels)
    n_in = wn.quantize_channels if wn.input_type == "mulaw-quantize" else 1

    def w(fan_in, *shape):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    d = lambda i, o: {"Dense_0": {"kernel": w(i, i, o),
                                  "bias": w(10, o) * 0.1}}
    tree = {f"residual_block_{i}": {
        "causal_conv": {"Conv_0": {"kernel": w(3 * R, 3, R, G),
                                   "bias": w(10, G) * 0.1}},
        "cin_conv": d(C, G), "skip_conv": d(G // 2, S),
        "out_conv": d(G // 2, R)} for i in range(wn.layers)}
    tree.update(input_convolution=d(n_in, R), final_convolution_1=d(S, S),
                final_convolution_2=d(S, wn.out_channels))
    if wn.input_type != "mulaw-quantize" and wn.out_channels > 2:
        nr = wn.out_channels // 3
        head = tree["final_convolution_2"]["Dense_0"]
        head["kernel"][:, nr:] *= 0.1
        head["bias"][nr:] = 0.0
        head["bias"][2 * nr:] = -3.0
    up = {}
    for i, scale in enumerate(wn.upsample_scales):
        k = np.zeros((3, 3, 1, scale), np.float32)
        k[1, 1] = 1.0
        up[f"up_{i}"] = {"Conv_0": {"kernel": k,
                                    "bias": np.zeros(scale, np.float32)}}
    tree["upsample_network"] = up
    return tree


def suppress_mol_noise(tree):
    """tests/test_pallas_kernels.py:_setup_mol's head: component 0's logit
    dominates and every log-scale is pinned to -30, so a draw is mean_0."""
    import copy
    tree = copy.deepcopy(tree)
    fc2 = tree["final_convolution_2"]["Dense_0"]
    fc2["bias"][0], fc2["bias"][1:10], fc2["bias"][20:30] = 100, -100, -30
    fc2["kernel"][:, 0:10] = 0.0
    fc2["kernel"][:, 20:30] = 0.0
    return tree


def to_cpu(x):
    """A tensor, or a (named) tuple of them such as SamplerParams, on
    the CPU (None stays None: a layer without gin weights)."""
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return type(x)(*map(to_cpu, x))
    return tuple(map(to_cpu, x)) if isinstance(x, tuple) else x.cpu()


def check_head(name, ws, cfg, W, wavs):
    """Phases 13-14: the kernel over the first W samples of `ws`'s last
    call, held by the teacher-forced oracle, and timed. Returns the
    `kernels` entry (launches filled in by the caller)."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.models.wavenet.distributions import (
        head_kind, inverse_cdf_pick)
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.ops.mulaw import inv_mulaw_quantize
    kind = head_kind(cfg)[0]
    wd = "bfloat16" if ws.weight_dtype == torch.bfloat16 else "float32"
    dts = dict(cache_dtype=ws.cache_dtype, weight_dtype=ws.weight_dtype)
    sp, kw = ws.sampler_params, ws.sampler_kernel
    c_w = ws.intermediates["c_up"][:, :W].contiguous()
    n_w = ws.intermediates["noise"][:, :, :W].contiguous()
    y_k = wk.sample(sp, cfg, c_w, n_w, kernel_weights=kw, **dts)
    torch.cuda.synchronize()
    ts = time.time()
    y_r, y_hat = wk.teacher_forced_replay(sp, cfg, c_w, n_w, y_k, **dts)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - ts)
    B = y_k.shape[0]
    got = y_k.cpu().numpy()
    if kind == "categorical":
        got = inv_mulaw_quantize(got.astype(np.int32),
                                 cfg.wavenet.quantize_channels - 1)
    assert np.array_equal(got, np.stack([w_[:W] for w_ in wavs])), \
        f"{name}: the kernel did not repeat the synthesizer's samples"
    nl = cfg.wavenet.out_channels // 3 if kind == "mol" else y_hat.shape[-1]
    atol = SAMPLER_REPLAY_ATOL[wd]

    def agree(y_a, y_b, lg):
        """Where run a's draws are run b's: the same class, or for MoL
        samples within atol (the sample of the component that b's logits
        `lg` pick at the same uniforms); and the ties of `lg`."""
        ties = wk.pick_ties(lg[..., :nl], n_w[0].to(lg.device),
                            SAMPLER_TIE_REL)
        same = (y_a == y_b) if kind == "categorical" else \
            (y_a - y_b).abs() <= atol
        return same, ties

    same, ties = agree(y_k, y_r, y_hat)
    n_moved = int((~same & ~ties).sum())
    err = float((y_k - y_r).abs()[same].max())
    want = inverse_cdf_pick(y_hat[..., :nl].reshape(B * W, nl),
                            n_w[0].reshape(-1))
    n_classes = len(torch.unique(want))
    print(f"{name}: {B}x{W} draws, {int((~same).sum())} differ from the "
          f"plain version's ({n_moved} off a tie), {int(ties.sum())} ties "
          f"within {SAMPLER_TIE_REL:g} of the total; {n_classes} distinct "
          f"picks; max |kernel - replay| where they agree {err:.3e}")
    assert n_classes > 4, f"{name}: the picks do not spread"
    assert err <= (atol if kind == "mol" else 0.0), err
    if wd == "float32":
        assert n_moved == 0, f"{name}: a draw differs off a tie"
    else:
        # the plain version's own spread: the same replay on the CPU
        y_c, y_hat_c = wk.teacher_forced_replay(
            to_cpu(sp), cfg, c_w.cpu(), n_w.cpu(), y_k.cpu(), **dts)
        same_c, ties_c = agree(y_c, y_r.cpu(), y_hat_c)
        n_moved_cpu = int((~same_c & ~ties_c).sum())
        print(f"{name}: the plain version on the GPU against itself on the "
              f"CPU: {int((~same_c).sum())} differ ({n_moved_cpu} off a "
              f"tie)")
        assert n_moved <= SAMPLER_BF16_MOVED * B * W, n_moved
        assert n_moved <= 2 * n_moved_cpu + 8, (n_moved, n_moved_cpu)
    ms = cuda_ms(lambda: wk.sample(sp, cfg, c_w, n_w, kernel_weights=kw,
                                   **dts), 3)
    bound_s, bound_by = sampler_bound_s(sp, cfg, B, W, wd == "bfloat16")
    print(f"{name}: kernel {ms:.3f} ms, plain (the replay) {plain_ms:.3f} "
          f"ms, bound {1e3 * bound_s:.4f} ms ({bound_by}); "
          f"{chain_us(ms, W, cfg)}")
    return {"name": name, "route": "cuda",
            "source": "tacotron2_tpu_torch/csrc/sampler.cu",
            "replaces": "tacotron2_tpu/ops/wavenet_kernel.py:180",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * bound_s,
            "bound_by": bound_by, "library_ms": None}


# phase 15's per-element tolerances of the teacher-forced kernel against
# its plain version, as shares of the elements within them
TF_WITHIN = ("frames within 1e-3", "stop logits within 1e-3 max(1, |l|)",
             "alignments within 1e-4")


def tf_spread(x, y):
    """Teacher-forced outputs (frames, stop logits, alignments) x against
    y: the largest and mean frame differences, the largest alignment and
    relative stop-logit differences, and the share of each output's
    elements within phase 15's tolerances."""
    f = (x[0] - y[0]).abs()
    s = (x[1] - y[1]).abs() / y[1].abs().clamp(min=1)
    a = (x[2] - y[2]).abs()
    share = lambda d, tol: float((d <= tol).float().mean())
    return {"frames max": float(f.max()), "frames mean": float(f.mean()),
            "stop logits max (relative)": float(s.max()),
            "alignments max": float(a.max()),
            TF_WITHIN[0]: share(f, 1e-3), TF_WITHIN[1]: share(s, 1e-3),
            TF_WITHIN[2]: share(a, 1e-4)}


# The bf16 autoregressive decode rounds what the TPU kernels round:
# every product input, the memory, the taps, the keys; the block route
# also v_a and the tanh. Another f32 sum order then moves an isolated
# rounding by one bf16 step (up to 2^-8 of a value), and a free run
# carries it on through the recurrent state, as in the teacher-forced
# kernel (phases 15-16), so a largest difference over a free run no longer
# measures a fault (the first reading after the repair: 5.9e-3 on phase
# 5's frames over 32 steps, 2.5e-1 on phase 17's cell states over 256). A
# bf16 decode kernel is held as phase 16 holds that rounded function
# (`replay_gate`): the plain version replays the kernel's own trajectory
# one step at a time, from the kernel's state (one-step launches chained,
# which repeat the kernel's launch over those steps bit for bit, with the
# route's roundings: `WHOLE` for the whole decode), so nothing carries.
# Every output and state field: finite; within its tolerance (OUT_TOL,
# states STATE_TOL, phase 16's RES_TOL) for at least REPLAY_WITHIN of its
# elements; no element past REPLAY_CAP_STEPS bf16 steps of the field's
# scale, max(1, its largest magnitude) (the largest reading was 5.7e-3, on
# frames under smoothing); and its mean difference at most REPLAY_MEAN_SHARE
# of that of the control. The control is the same plain step with f32
# activations (the same bf16-valued weights upcast: nothing rounded),
# replayed on the same trajectory; it must fail the share or the cap, so
# the gate tells a kernel that skips the roundings from one that makes
# them. A wiring fault moves every step by O(0.1-1).
OUT_TOL = {"frames": 1e-3, "stops": 1e-4, "alignments": 1e-4}
STATE_TOL = 1e-3
REPLAY_CAP_STEPS = 4
REPLAY_MEAN_SHARE = 0.1


def f32_activations(dp):
    """The same weights upcast to f32: the plain version then rounds
    nothing (the control of `replay_gate`)."""
    return type(dp)(*[t.float() for t in dp])


def replay_gate(name, step_k, step_p, step_c, state0, drop, full):
    """The gate above: step_k(state, drop_t), step_p(state, drop_t) and
    step_c(state, drop_t) run one step (kernel, plain, the control) and
    return (frames, stops, alignments, state); `full` is the kernel's launch
    of all of drop's steps from state0 (its frames, and its state where it
    returns one), which the chained one-step launches must repeat bit for
    bit. Prints the readings, returns the kernel's largest difference."""
    import torch
    diffs, ctrl, scale, st, frames = {}, {}, {}, state0, []
    for t in range(drop.shape[1]):
        d = drop[:, t:t + 1].contiguous()
        k = step_k(st, d)
        p = state_dict(step_p(st, d))
        c = state_dict(step_c(st, d))
        for n, x in state_dict(k).items():
            y = p[n].float()
            diffs.setdefault(n, []).append((x.float() - y).abs().flatten())
            ctrl.setdefault(n, []).append((c[n].float() - y).abs().flatten())
            scale[n] = max(scale.get(n, 1.0), float(y.abs().max()))
        frames.append(k[0])
        st = k[3]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(frames, 1), full[0]) and (
        len(full) < 4 or torch.equal(st.c1, full[3].c1)), \
        f"{name}: one-step launches do not repeat the kernel's launch"

    def reading(dd, tol):
        return (bool(torch.isfinite(dd).all()), float(dd.max()),
                float((dd <= tol).float().mean()), float(dd.mean()))

    rows, worst, faults, ctrl_fails = [], 0.0, [], []
    for n, ds in diffs.items():
        tol = OUT_TOL.get(n, STATE_TOL)
        cap = REPLAY_CAP_STEPS * 2.0 ** -8 * scale[n]
        fin, mx, share, mean = reading(torch.cat(ds), tol)
        cfin, cmx, cshare, cmean = reading(torch.cat(ctrl[n]), tol)
        worst = max(worst, mx)
        rows.append(f"{n} max {mx:.1e} (cap {cap:.2g}) within {tol:g} "
                    f"{share:.6f}, mean {mean:.1e} (control: max {cmx:.1e} "
                    f"within {cshare:.6f}, mean {cmean:.1e})")
        if not (fin and mx <= cap and share >= REPLAY_WITHIN
                and mean <= REPLAY_MEAN_SHARE * cmean):
            faults.append(n)
        if not (cfin and cmx <= cap and cshare >= REPLAY_WITHIN):
            ctrl_fails.append(n)
    print(f"{name}, the plain step replayed on the kernel's trajectory "
          f"(control: the plain step with f32 activations): "
          + "; ".join(rows) + f"; the control fails on {ctrl_fails}")
    assert not faults, (name, faults)
    assert ctrl_fails, f"{name}: the gate does not tell the control apart"
    return worst


def state_dict(out):
    """(frames, stops, alignments[, state]) -> {field: tensor}."""
    d = dict(zip(("frames", "stops", "alignments"), out[:3]))
    if len(out) > 3:
        d.update({f"state.{n}": getattr(out[3], n)
                  for n in out[3]._fields if getattr(out[3], n) is not None})
    return d


def gta_phase(cfg, tparams, stats, seed):
    """Phase 15: GTA of the r5 train split through the teacher-forced
    kernel, held against its plain version and the TPU run's GTA MAE,
    timed; `synthesize --model Tacotron-2 --mode gta`; the `style_embs` and
    `synthesis` modes. Returns the `kernels` entry."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
    a = cfg.audio
    t0 = phase(15, f"(h) GTA of the {N_TRAIN} r5 train texts, batches of "
               f"{GTA_BATCH}")
    texts = corpus_texts()
    mels = [np.load(os.path.join(R5, "corpus", "mels", f"mel-{i}.npy"))
            for i in range(len(texts))]
    # scripts/make_tiny_dataset.py:84-90 renders 0.06 s = 960 samples a
    # character: floor(4.8 frames a character) + 1 at hop 200
    spc = int(0.06 * a.sample_rate)
    assert all(len(m) == len(t) * spc // a.hop_size + 1
               for t, m in zip(texts, mels)), "texts do not match the mels"
    texts, mels = texts[:N_TRAIN], mels[:N_TRAIN]
    refs = [m[:T_REF] for m in mels]
    synth = TacotronSynthesizer(cfg, tparams, stats, device="cuda",
                                seed=seed, keep_intermediates=True)
    tk.launches = dk.launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    gta, first = [], None
    for i in range(0, N_TRAIN, GTA_BATCH):
        sl = slice(i, i + GTA_BATCH)
        out = synth.synthesize(texts[sl], refs[sl], refs[sl],
                               mel_targets=mels[sl], gta=True)
        first = first or dict(synth.intermediates)
        gta.extend(out["mels"])
    torch.cuda.synchronize()
    gta_s = time.time() - ts
    launches = tk.launches
    maes = [float(np.abs(g[:len(t)] - t[:len(g)]).mean())
            for g, t in zip(gta, mels)]
    mae = float(np.mean(maes))
    B, T, M = first["memory"].shape
    steps = first["teacher"].shape[0]
    kw_rows = synth.teacher_forced_weights()[1].rows
    print(f"GTA: {gta_s:.3f} s for {N_TRAIN} utterances; teacher-forced "
          f"launches {launches} (csrc/decoder_rows.cu, {-(-B // 8)} clusters "
          f"of {kw_rows.cs} CTAs; csrc/decoder.cu {dk.launches}); first "
          f"batch B={B}, T_in={T}, {steps} steps; GTA mel MAE vs ground truth"
          f" mean {mae:.4f} (TPU run {TPU_GTA_MAE}; gate {GTA_MAE_MAX}), rows"
          f" {min(maes):.4f}-{max(maes):.4f}")
    assert launches == N_TRAIN // GTA_BATCH and dk.launches == 0, launches
    assert all(g.shape == m.shape and np.isfinite(g).all()
               for g, m in zip(gta, mels))
    assert mae <= GTA_MAE_MAX, mae

    # kernel vs plain on the first batch, the same multipliers
    dp, kw = synth.teacher_forced_weights()
    args = (dp, cfg, first["keys"], first["memory"], first["mask"],
            first["teacher"], first["coins"], first["drop"])
    k_out = tk.teacher_forced_fwd(*args, kernel_weights=kw)
    p_out = tk.teacher_forced_fwd_plain(*args)
    # the plain version in another sum order (on the CPU), and with f32
    # activations (the same bf16-valued weights as f32: no rounding)
    to_cpu = lambda x: x.cpu()
    c_out = tk.teacher_forced_fwd_plain(type(dp)(*map(to_cpu, dp)), cfg,
                                        *map(to_cpu, args[2:]))
    f_out = tk.teacher_forced_fwd_plain(type(dp)(*[t.float() for t in dp]),
                                        *args[1:])
    torch.cuda.synchronize()
    k_out, p_out, f_out = ([t.cpu() for t in o] for o in (k_out, p_out,
                                                          f_out))
    spread = {n: tf_spread(x, p_out) for n, x in (
        ("kernel", k_out), ("plain on the CPU", c_out),
        ("plain with f32 activations", f_out))}
    for n, d in spread.items():
        print(f"teacher-forced, first batch, {n} vs plain: " + ", ".join(
            f"{k} {v:.3e}" for k, v in d.items()))
    errs = spread["kernel"]
    # Both round each activation to bf16 where it enters a product, as the
    # TPU kernel does; another f32 sum order moves an isolated rounding by
    # a step (up to 2^-7 of a value), which one product carries to ~1e-2:
    # the plain version itself, on the CPU, differs from it on the GPU by
    # up to 3.3e-2 in frames (PERF.md §6). So the stated tolerances
    # hold element by element for all but those moved roundings, the mean
    # frame difference stays at that level, and the kernel lies far closer
    # to this bf16 function than to the one with f32 activations.
    assert min(errs[k] for k in TF_WITHIN) >= 0.99, errs
    assert errs["frames mean"] <= 1e-4, errs
    assert errs["frames mean"] <= 0.1 * spread[
        "plain with f32 activations"]["frames mean"], spread
    tf_ms = cuda_ms(lambda: tk.teacher_forced_fwd(*args, kernel_weights=kw),
                    3)
    tf_plain_ms = cuda_ms(lambda: tk.teacher_forced_fwd_plain(*args), 1)
    b8 = [x[:8] for x in (first["keys"], first["memory"], first["mask"])]
    args8 = (dp, cfg, *b8, first["teacher"][:, :8].contiguous(),
             first["coins"], first["drop"][:8])
    tf_ms8 = cuda_ms(lambda: tk.teacher_forced_fwd(*args8, kernel_weights=kw),
                     3)
    mels_n = cfg.audio.num_mels
    bound_s, bound_by = decode_bound_s(dp, cfg, B, T, M, steps, B * steps,
                                       align=True,
                                       in_bytes=4 * steps * (B * mels_n + 1))
    print(f"teacher-forced kernel at B={B}, T_in={T}, {steps} steps: kernel "
          f"{tf_ms:.3f} ms, plain {tf_plain_ms:.3f} ms, bound "
          f"{1e3 * bound_s:.4f} ms ({bound_by}); at B=8: kernel "
          f"{tf_ms8:.3f} ms")

    with tempfile.TemporaryDirectory() as tmp:
        # a train.txt over the r5 mels: <tmp>/corpus is the corpus
        os.symlink(os.path.join(R5, "corpus"), os.path.join(tmp, "corpus"))
        train_txt = os.path.join(tmp, "train.txt")
        hop = a.effective_hop
        with open(train_txt, "w", encoding="utf-8") as f:
            for i, (t, m) in enumerate(zip(texts, mels)):
                f.write(f"corpus|audio-{i}.npy|mel-{i}.npy|linear-{i}.npy|"
                        f"embed-{i}.npy|{len(m) * hop}|{len(m)}|{t}|0|"
                        f"{i % 2}|utt{i}.wav|F\n")
        hp = ("tacotron.compute_dtype=bfloat16,audio.trim_silence=false,"
              f"tacotron.max_iters={MAX_STEPS},"
              "train.wavenet_synthesis_batch_size=8")
        taco_ckpt = os.path.join(R5, "taco_ckpt.msgpack")
        out = os.path.join(tmp, "out")
        tk.launches = 0
        wk.launches = 0
        torch.cuda.synchronize()
        ts = time.time()
        wav_paths = cli.main([
            "--hparams", hp, "synthesize", "--model", "Tacotron-2", "--mode",
            "gta", "--input-path", train_txt, "--limit", "8",
            "--checkpoint", taco_ckpt, "--wavenet-checkpoint",
            os.path.join(R5, "wn_ckpt.msgpack"), "--output-dir", out,
            "--seed", str(seed)])
        torch.cuda.synchronize()
        cli_s = time.time() - ts
        cli_launches = {"tacotron_teacher_forced": tk.launches,
                        "wavenet_sampler": wk.launches}
        rows = open(os.path.join(out, "gta", "map.txt"),
                    encoding="utf-8").read().splitlines()
        assert len(rows) == len(wav_paths) == 8, (rows, wav_paths)
        voc = []
        for i, (row, p) in enumerate(zip(rows, wav_paths)):
            _, gt_path, gta_path, n_samples, text = row.split("|")
            assert text == texts[i] and int(n_samples) == len(mels[i]) * hop
            g = np.load(gta_path)
            with wave.open(p, "rb") as f:
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            wav = pcm.astype(np.float32) / 32767
            assert g.shape == mels[i].shape and len(wav) == len(g) * hop
            q = wav_quality(wav, g, np.load(gt_path), a)
            voc.append(q[1])
            print(f"GTA Tacotron-2 row {i}: mel {g.shape}, wav {len(wav)} "
                  f"samples, vocoder_fidelity_corr {q[1]:.4f}, "
                  f"text_to_wav_mel_corr {q[0]:.4f}")
        print(f"synthesize --model Tacotron-2 --mode gta --limit 8: "
              f"{cli_s:.3f} s, launches {cli_launches}; "
              f"vocoder_fidelity_corr min {min(voc):.4f} mean "
              f"{np.mean(voc):.4f}")
        assert all(n > 0 for n in cli_launches.values()), cli_launches
        # as phases 7 and 12: a vocoder or mel wiring fault drops the
        # correlation far below 0.7
        assert min(voc) >= 0.70, voc

        # style_embs: 2 speakers x 4 utterances through `embed`
        tk.launches = 0
        emb_dir = cli.main([
            "--hparams", hp, "synthesize", "--model", "Tacotron", "--mode",
            "style_embs", "--input-path", train_txt, "--n-spk", "2",
            "--n-per-spk", "4", "--checkpoint", taco_ckpt, "--output-dir",
            out, "--seed", str(seed)])
        embs = {n: np.loadtxt(os.path.join(emb_dir, f"emb_{n}.tsv"),
                              delimiter="\t") for n in ("emt", "spk")}
        meta = open(os.path.join(emb_dir, "meta.tsv")).read().splitlines()
        cos = [float(np.sum(e[:8] * e[8:], 1).mean() / np.mean(
            np.linalg.norm(e[:8], axis=1) * np.linalg.norm(e[8:], axis=1)))
            for e in embs.values()]
        print(f"style_embs: {len(meta) - 1} rows, embeddings "
              f"{[e.shape for e in embs.values()]}, teacher-forced launches "
              f"{tk.launches}; mean cosine of reference vs output-mel "
              f"embeddings emt {cos[0]:.4f} spk {cos[1]:.4f}")
        assert len(meta) == 17 and tk.launches == 1
        assert all(e.shape == (16, 128) and np.isfinite(e).all()
                   for e in embs.values())

        # synthesis: 4 rows, each with another row's mel as its emotion
        # reference and a third's as its speaker reference
        meta_path = os.path.join(tmp, "synth_meta.txt")
        with open(meta_path, "w", encoding="utf-8") as f:
            for i in range(4):
                m = mels[i]
                f.write(f"corpus|audio-{i}.npy|mel-{i}.npy|l|e|"
                        f"{len(m) * hop}|{len(m)}|{texts[i]}|0|0|utt{i}.wav|"
                        f"F|corpus/mel-{i + 4}.npy|x{i}|corpus/mel-{i + 8}"
                        ".npy\n")
        map_path = cli.main([
            "--hparams", hp, "synthesize", "--model", "Tacotron", "--mode",
            "synthesis", "--synth-metadata", meta_path, "--input-dir", tmp,
            "--checkpoint", taco_ckpt, "--output-dir", out, "--seed",
            str(seed)])
        rows = open(map_path, encoding="utf-8").read().splitlines()
        lens = []
        for i, row in enumerate(rows):
            m_i = np.load(row.split("|")[0])
            lens.append(m_i.shape[0])
            w_path = os.path.join(os.path.dirname(map_path), "wavs",
                                  f"wav-utt{i}_x{i}.wav")
            with wave.open(w_path, "rb") as f:
                assert f.getnframes() == hop * (m_i.shape[0] - 1)
            assert np.isfinite(m_i).all() and row.split("|")[1] == texts[i]
        print(f"synthesis: {len(rows)} rows, mel frames {lens} (stop within "
              f"{MAX_STEPS} steps), Griffin-Lim wavs written")
        assert len(rows) == 4 and max(lens) < MAX_STEPS
    done(15, t0)
    return {"name": "tacotron_teacher_forced", "route": "cuda",
            "source": "tacotron2_tpu_torch/csrc/decoder_rows.cu",
            "replaces": "tacotron2_tpu/ops/tacotron_train_kernel.py:118",
            "launches": launches, "max_abs_err": errs["frames max"],
            "ms": tf_ms, "plain_ms": tf_plain_ms,
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
            "library_ms": None}


# phase 16: the r5 script's Tacotron training, at its padded shapes
# (--taco-batch 16, text padded to 96 as phase 15, mels to 448 frames);
# its scheduled teacher forcing (hold 1.0 for a third of its 12,000 steps)
TRAIN_BATCH, TRAIN_STEPS, TAKO_STEPS = 16, 32, 12000
PAD_TEXT, PAD_MEL = 96, 448
# taco_curve.jsonl's held_mel_mae at step 12000 and this run's gate
TPU_HELD_MAE, HELD_MAE_MAX = 0.0188, 0.0235
# kernel 4a's train mode against its plain version (dropout and zoneout
# masks and tfr-0.5 coins the same on both). Both round each activation
# to bf16 where it enters a product, and another f32 sum order moves an
# isolated rounding by a step (phase 15). Free run: the outputs held as
# phase 15 holds them (TF_WITHIN shares, and a mean frame difference at
# most 0.1x that of the plain version with f32 activations), and every
# residual's mean difference at most 0.1x that of the f32-activation
# version: where the kernel's own frames are fed back, a moved rounding
# carries on through the recurrent state. Replay: the plain step replayed
# on the kernel's own trajectory one step at a time (nothing carries), each
# output and residual within its tolerance (the states, gates, prenet
# outputs and frames as phase 15's frames; alignments and cumulative
# alignments as its alignments) for >= REPLAY_WITHIN of the elements
RES_TOL = dict(out=1e-3, align=1e-4, cum_pre=1e-4, q=1e-3, z1=1e-3,
               z2=1e-3, h0d=1e-3, hpre=1e-3, ctx=1e-3, h1=1e-3, c1=1e-3,
               h2=1e-3, c2=1e-3)
REPLAY_WITHIN = 0.999
# kernel 4b against its plain version on the kernel's own residuals: the
# same rounded operands and f32 gradients in another sum order, each
# gradient within this share of its largest magnitude (the prediction;
# the first reading at these shapes was at most 2.1e-6). f32 weights
# (phase 20) throughout; with bf16 weights the sums that nothing rounds
# (dkeys, dva) under the replay below
BWD_RTOL = 1e-4
# kernel 4b with bf16 weights rounds each gradient where it enters a
# product, as build_train_bwd does, so another sum order may move a
# rounding by a step, which then feeds every earlier step: the plain
# backward is replayed on the kernel's own rounded gradients and carried
# cumulative-alignment gradient (`teacher_forced_bwd_plain(replay=...)`),
# and each gradient is held as the replayed decode gates hold a field: its
# largest difference within BWD_CAP_STEPS bf16 steps (2^-8 each) of its
# largest magnitude, its mean difference at most REPLAY_MEAN_SHARE of that
# of the control, the same replay without the gradient rounding, which
# must itself fail the gate
BWD_CAP_STEPS = 4
# one whole train step, FusedTeacherForced (kernels 4a, 4b) against
# autograd through the plain decode, at the schedule's ratio 1.0: the
# forwards differ where another sum order moves an isolated bf16 rounding
# (phase 15: ~0.2% of frames, up to 3e-2), which moves the gradients at
# those steps. The cosine of all gradients flattened, and each tensor's
# largest difference as a share of its largest gradient, that floored at
# STEP_FLOOR of the largest gradient of any tensor: the reference
# encoders' conv biases feed BatchNorm directly, which cancels them, so
# their gradient is 0 up to rounding and has no scale of its own
STEP_COSINE = 0.999
STEP_RTOL = 5e-2
STEP_FLOOR = 1e-3


def rel_err(x, y):
    return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)


def hold_train_fwd(name, fargs, k_f):
    """Kernel 4a's train mode (k_f, its launch on fargs, bf16 weights)
    against its plain version, as the comment above RES_TOL says: the free
    run's outputs within TF_WITHIN for >= 99% of their elements, its frames'
    and every residual's mean difference at most 0.1x that of the plain
    version with f32 activations, and the plain step replayed on the
    kernel's trajectory within RES_TOL for >= REPLAY_WITHIN of each
    residual's elements. Prints the readings; returns the free run's
    spread (`tf_spread`)."""
    import torch
    from tacotron2_tpu_torch.models.tacotron.decoder import (
        teacher_forced_replay)
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    dp = fargs[0]
    p_f = tk.teacher_forced_train_fwd_plain(*fargs)
    f_f = tk.teacher_forced_train_fwd_plain(f32_activations(dp), *fargs[1:])
    torch.cuda.synchronize()
    spread = {n: tf_spread(x[:3], p_f[:3]) for n, x in (
        ("kernel", k_f), ("plain with f32 activations", f_f))}
    for n, d in spread.items():
        print(f"{name}, {n} vs plain: " + ", ".join(
            f"{k} {v:.3e}" for k, v in d.items()))
    errs = spread["kernel"]
    replay = teacher_forced_replay(*fargs, k_f[3])
    free, rep_share = {}, {}
    for field, tol in RES_TOL.items():
        k, p, f = k_f[3][field], p_f[3][field], f_f[3][field]
        free[field] = (float((k - p).abs().mean()),
                       float((f - p).abs().mean()))
        d = (k - replay[field]).abs()
        rep_share[field] = float((d <= tol).float().mean())
        print(f"  {field}: free run mean |kernel - plain| "
              f"{free[field][0]:.3e} (f32 activations {free[field][1]:.3e});"
              f" replay max {float(d.max()):.3e}, within {tol:g}: "
              f"{rep_share[field]:.6f}")
    del replay
    assert min(errs[k] for k in TF_WITHIN) >= 0.99, (name, errs)
    assert errs["frames mean"] <= 0.1 * spread[
        "plain with f32 activations"]["frames mean"], (name, spread)
    assert all(k <= 0.1 * f for k, f in free.values()), (name, free)
    assert min(rep_share.values()) >= REPLAY_WITHIN, (name, rep_share)
    return errs


def train_config():
    """r5_config() with the r5 script's scheduled teacher forcing."""
    cfg = r5_config()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, tacotron_teacher_forcing_mode="scheduled",
        tacotron_teacher_forcing_init_ratio=1.0,
        tacotron_teacher_forcing_start_decay=TAKO_STEPS // 3,
        tacotron_teacher_forcing_decay_steps=TAKO_STEPS))


def train_bound_s(dp, cfg, B, T, M, S, backward):
    """Least seconds of the train forward (backward=False: decode_bound_s
    plus the teacher, the masks and the residuals written) or the
    backward: its bytes (weights once; per row-step the residuals, masks,
    multipliers and incoming gradients read and the activation gradients
    written; keys and memory once, the per-row sums once) and its
    operations — the transposed products at the rate of their operands
    (bf16 weights: bf16 × bf16 on the tensor cores; f32 weights: three
    TF32 products, TF32_FLOPS / 3), the attention's recompute and gradient
    sums at the f32 rate."""
    tc, mels = cfg.tacotron, cfg.audio.num_mels
    r = tc.outputs_per_step
    U, P = tc.decoder_lstm_units, tc.prenet_layers[-1]
    A, KW = dp.wq.shape[1], dp.loc_k.shape[0]
    FO = r * mels + r
    rows = B * S
    res = T + A + 12 * U + 2 * P + M          # cum, q, z1, z2, c, h, prenet, ctx
    if not backward:
        extra = 4 * S * B * mels + rows * (4 * U + 4 * res)
        return decode_bound_s(dp, cfg, B, T, M, S, rows, align=True,
                              in_bytes=extra)
    w_bytes = sum(t.numel() * t.element_size() for t in dp)
    d_bytes = (w_bytes + 4 * B * T * (2 * A + M) + 4 * B * 8 * (KW + 1) * A
               + rows * (4 * (2 * T + A + 10 * U + 4 * P + FO + T)
                         + 4 * U
                         + 4 * (8 * U + 2 * P + FO + M + A)))
    macs = (mels * P + P * P + (P + M + U) * 4 * U + 2 * U * 4 * U + U * A
            + (U + M) * FO + T * M)
    att = T * A * (3 * KW + 12) + 10 * T + 30 * U
    mm_rate = (BF16_FLOPS if dp.l1_wp.element_size() == 2
               else TF32_FLOPS / 3)
    ops_s = rows * (2 * macs / mm_rate + att / F32_FLOPS)
    bytes_s = d_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


# the step splits (ms) of the Tacotron training phases, for phase 26's
# side-by-side print
STEP_SPLITS = {}


def training_phase(tparams, stats, seed):
    """Phase 16: Tacotron training at the r5 shapes. Returns the `kernels`
    entries of kernel 4a's train mode and kernel 4b."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.convert import (flax_named_parameters,
                                             load_tacotron)
    from tacotron2_tpu_torch.eval.convergence import (alignment_diagonality,
                                                      batch_from_rows,
                                                      masked_mel_mae)
    from tacotron2_tpu_torch.models.tacotron.decoder import (
        drop_masks, teacher_inputs, zoneout_masks)
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    from tacotron2_tpu_torch.train.tacotron_step import (StepTimer,
                                                         TacotronTrainer)
    cfg = train_config()
    t0 = phase(16, f"(i) Tacotron training: B={TRAIN_BATCH}, T_in "
               f"{PAD_TEXT}, {PAD_MEL} steps, the r5 train split")
    texts = corpus_texts()
    mel_dir = os.path.join(R5, "corpus", "mels")
    rows = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
            for i, t in enumerate(texts)]
    batch = lambda rs: batch_from_rows(rs, mel_dir, cfg, pad_text_to=PAD_TEXT,
                                       pad_mel_to=PAD_MEL)
    first = batch(rows[:TRAIN_BATCH])
    assert first["inputs"].shape == (TRAIN_BATCH, PAD_TEXT)
    assert first["mel_targets"].shape[1] == PAD_MEL
    dev = torch.device("cuda")

    # ---- (1) kernel 4a, train mode, against its plain version: the r5
    # weights, the first batch's keys and memory, the same masks
    model = load_tacotron(Tacotron(cfg), tparams, stats).to(dev)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in first.items()}
    with torch.no_grad():
        keys, memory, mask, _, _ = model.synthesis_memory_ext(
            tb["inputs"], tb["input_lengths"], tb["ref_mel_emt"],
            tb["ref_mel_spk"])
        dp = tk.cast_params(tk.extract_params_traced(model.decoder, cfg),
                            torch.bfloat16)
    kw = dk.pack_weights(dp)
    g = torch.Generator(device=dev).manual_seed(seed)
    B, T, M = memory.shape
    S = PAD_MEL // cfg.tacotron.outputs_per_step
    teacher = teacher_inputs(tb["mel_targets"], cfg.tacotron.outputs_per_step)
    coins = (torch.rand(S, generator=g, device=dev) < 0.5).to(torch.int32)
    drop = drop_masks(cfg, B, S, g, dev)
    zmask = zoneout_masks(cfg, B, S, g, dev)
    fargs = (dp, cfg, keys, memory, mask, teacher, coins, drop, zmask)
    plan = dk.rows_plan(dk.rows_widths(cfg, M, T), kw.rows.cs, False)
    print(f"kernel 4a (csrc/decoder_rows.cu, teacher-forced mode) plan: "
          f"{-(-B // 8)} clusters of {kw.rows.cs} CTAs, 8 rows each; {plan}")
    dk.launches = tk.train_launches = 0
    k_f = tk.teacher_forced_train_fwd(*fargs, kernel_weights=kw)
    print(f"kernel 4a train mode: {int(coins.sum())} of {S} coins set, "
          f"zoneout masks {float(zmask.float().mean()):.4f} kept, prenet "
          f"dropout {float((drop > 0).float().mean()):.4f} kept; launches: "
          f"rows kernel {tk.train_launches}, decoder.cu {dk.launches}")
    assert (tk.train_launches, dk.launches) == (1, 0)
    errs = hold_train_fwd("train forward", fargs, k_f)

    # ---- (2) kernel 4b against its plain version replayed on the kernel's
    # gradients, both on the kernel's residuals; then weight_grads of each
    res = k_f[3]
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    FO = k_f[3]["out"].shape[-1]
    dout = torch.randn(B, S, FO, generator=gd, device=dev) * 1e-3
    dalign = torch.randn(B, S, T, generator=gd, device=dev) * 1e-3
    bargs = (dp, cfg, res, keys, memory, mask, coins, drop, zmask, dout,
             dalign)
    widths = tk.bwd_widths(cfg, kw, M, T)
    cs = tk.bwd_cluster_size(widths)
    plan = tk.bwd_plan(widths, cs, False)
    print(f"kernel 4b plan: {-(-B // 8)} clusters of {cs} CTAs, 8 rows "
          f"each; {plan['smem']} B of shared memory a CTA ({plan['slots']} "
          f"ring slots of 32 KB), weight stream {plan['stream']} B a CTA + "
          f"{plan['shared']} B shared, global scratch {plan['scratch']} B a "
          f"cluster ({plan['spill']} B a CTA spilled)")
    k_b = tk.teacher_forced_bwd(*bargs, kernel_weights=kw)
    k_b2 = tk.teacher_forced_bwd(*bargs, kernel_weights=kw)
    p_b = tk.teacher_forced_bwd_plain(*bargs, replay=k_b)
    c_b = tk.teacher_forced_bwd_plain(*bargs, round_gradients=False,
                                      replay=k_b)
    k_w = tk.weight_grads(cfg, dp, res, k_b, teacher, coins)
    p_w = tk.weight_grads(cfg, dp, res, p_b, teacher, coins)
    c_w = tk.weight_grads(cfg, dp, res, c_b, teacher, coins)
    torch.cuda.synchronize()
    rerun = all(torch.equal(k_b[n], k_b2[n]) for n in k_b)
    del k_b2
    name_w = lambda i: ("dkeys_input", "dmemory")[i - len(dp)] if i >= len(
        dp) else f"d{dp._fields[i]}"
    k_all = dict(k_b, **{name_w(i): x for i, x in enumerate(
        [*k_w[0], k_w[1], k_w[2]])})
    p_all = dict(p_b, **{name_w(i): x for i, x in enumerate(
        [*p_w[0], p_w[1], p_w[2]])})
    c_all = dict(c_b, **{name_w(i): x for i, x in enumerate(
        [*c_w[0], c_w[1], c_w[2]])})
    # what the rounding does not reach under the replay (the control gives
    # it bit for bit: dkeys, dva and what follows from them alone) is held
    # as f32
    unrounded = [n for n in p_all if torch.equal(c_all[n], p_all[n])]
    bwd_err, shares = {}, {}
    for n, y in p_all.items():
        d = (k_all[n] - y).abs()
        bwd_err[n] = float(d.max()) / max(float(y.abs().max()), 1e-30)
        if n not in unrounded:
            shares[n] = float(d.mean()) / float((c_all[n] - y).abs().mean())
    print("kernel 4b vs its plain version replayed on the kernel's "
          "gradients, max |difference| / max |plain| per gradient (mean "
          "|difference| / the control's): " + ", ".join(
              f"{n} {v:.2e}" + (f" ({shares[n]:.3f})" if n in shares else "")
              for n, v in bwd_err.items()))
    print(f"kernel 4b rerun bit-identical: {rerun}")
    cap = BWD_CAP_STEPS * 2.0 ** -8
    assert rerun
    assert all(bwd_err[n] <= BWD_RTOL for n in unrounded), bwd_err
    assert all(bwd_err[n] <= cap for n in shares), bwd_err
    # the control fails the gate in every gradient the rounding reaches
    # (its own mean share is 1); the kernel passes it
    assert {"dz1", "dz2", "dproj", "dq", "dwp"} <= set(shares), unrounded
    assert max(shares.values()) <= REPLAY_MEAN_SHARE, shares
    bwd_abs = max(float((k_b[n] - p_b[n]).abs().max()) for n in p_b)
    del p_b, c_b, c_w, k_all, p_all, c_all

    tf_ms = cuda_ms(lambda: tk.teacher_forced_train_fwd(
        *fargs, kernel_weights=kw), 3)
    tf_plain_ms = cuda_ms(lambda: tk.teacher_forced_train_fwd_plain(*fargs), 1)
    bwd_ms = cuda_ms(lambda: tk.teacher_forced_bwd(*bargs, kernel_weights=kw),
                     3)
    bwd_plain_ms = cuda_ms(lambda: tk.teacher_forced_bwd_plain(*bargs), 1)
    wg_ms = cuda_ms(lambda: tk.weight_grads(cfg, dp, res, k_b, teacher,
                                            coins), 3)
    fb = train_bound_s(dp, cfg, B, T, M, S, backward=False)
    bb = train_bound_s(dp, cfg, B, T, M, S, backward=True)
    print(f"at B={B}, T_in={T}, {S} steps: kernel 4a train {tf_ms:.3f} ms "
          f"(plain {tf_plain_ms:.3f}, bound {1e3 * fb[0]:.4f} ms, {fb[1]}); "
          f"kernel 4b {bwd_ms:.3f} ms (plain {bwd_plain_ms:.3f}, bound "
          f"{1e3 * bb[0]:.4f} ms, {bb[1]}); weight_grads {wg_ms:.3f} ms")
    del k_f, k_b, k_w, p_w, res

    # ---- (3) one whole train step: every parameter gradient through
    # FusedTeacherForced against autograd through the plain decode, the
    # same weights, batch and random draws (the schedule's ratio 1.0)
    trainer = TacotronTrainer(cfg)
    state = trainer.init_state(model=model)
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    out = {}
    for route in ("fused", "autograd"):
        for n, b in model.named_buffers():
            b.copy_(bufs[n])
        terms, params, grads, tfr = trainer.gradients(
            state, first, torch.Generator(device=dev).manual_seed(seed),
            decode=route)
        out[route] = (float(terms["loss"].detach()),
                      [x.detach() for x in grads])
    names = [n for n, _ in flax_named_parameters(model)]
    gf, ga = out["fused"][1], out["autograd"][1]
    floor = STEP_FLOOR * max(float(y.abs().max()) for y in ga)
    rels = {n: float((x - y).abs().max()) / max(float(y.abs().max()), floor)
            for n, x, y in zip(names, gf, ga)}
    cos = float(torch.nn.functional.cosine_similarity(
        torch.cat([x.flatten() for x in gf]),
        torch.cat([y.flatten() for y in ga]), dim=0))
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:6]
    print(f"whole step at tfr {tfr}: loss fused {out['fused'][0]:.6f} "
          f"autograd {out['autograd'][0]:.6f}; gradient cosine {cos:.6f}; "
          f"largest per-tensor max|d| / max(max|g|, {floor:.3e}): " + ", ".join(
              f"{n} {v:.2e}" for n, v in worst))
    assert abs(out["fused"][0] - out["autograd"][0]) <= 1e-3 * abs(
        out["autograd"][0]), out
    assert cos >= STEP_COSINE, cos
    assert max(rels.values()) <= STEP_RTOL, worst
    for n, b in model.named_buffers():
        b.copy_(bufs[n])
    del out, gf, ga, grads, params

    # ---- (4) training from init_tacotron: the main path's counts
    trainer = TacotronTrainer(cfg)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    n_b = N_TRAIN // TRAIN_BATCH
    batches = [batch(rows[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(n_b)]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    order, losses, split = [], [], {}
    tk.train_launches = tk.bwd_launches = dk.launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    for i in range(TRAIN_STEPS):
        if not order:
            order = list(rng.permutation(n_b))
        timed = 4 <= i < 8
        trainer.timer = StepTimer() if timed else None
        torch.cuda.synchronize()
        t_step = time.time()
        state, m = trainer.train_step(state, batches[order.pop()], gen)
        losses.append(float(m["loss"]))
        if timed:
            for k, v in trainer.timer.totals().items():
                split[k] = split.get(k, 0.0) + v / 4
            split["step (host clock)"] = split.get(
                "step (host clock)", 0.0) + 1e3 * (time.time() - t_step) / 4
    torch.cuda.synchronize()
    train_s = time.time() - ts
    launches = (tk.train_launches, tk.bwd_launches)
    trainer.timer = None
    print(f"{TRAIN_STEPS} train steps from init_tacotron: {train_s:.3f} s; "
          f"kernel launches 4a {launches[0]} (csrc/decoder_rows.cu), 4b "
          f"{launches[1]}; loss " + " ".join(f"{x:.4f}" for x in losses))
    print("ms per step (mean of steps 5-8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    split["rest of backward"] = (split["backward"]
                                 - split["backward (kernel 4b)"]
                                 - split["weight_grads"])
    print(f"  rest of backward {split['rest of backward']:.3f} ms")
    STEP_SPLITS["phase 16"] = dict(split)
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert launches == (TRAIN_STEPS, TRAIN_STEPS), launches
    assert dk.launches == 0, "the train forward left csrc/decoder_rows.cu"

    # ---- (5) the r5 checkpoint's natural eval on the 32 held-out rows
    state = TacotronTrainer(cfg).init_state(model=model)
    held = batch(rows[N_TRAIN:])
    out, terms = trainer.eval_step(
        state, held, torch.Generator(device=dev).manual_seed(123))
    mae = masked_mel_mae(out["mel_outputs"].float().cpu().numpy(), held)
    diag = float(np.mean(alignment_diagonality(
        out["alignments"].float().cpu().numpy(), held["input_lengths"],
        held["targets_lengths"], cfg.tacotron.outputs_per_step)))
    print(f"r5 checkpoint eval_step on {len(rows) - N_TRAIN} held-out rows: "
          f"masked_mel_mae {mae:.4f} (TPU run {TPU_HELD_MAE} at step "
          f"12000; gate {HELD_MAE_MAX}), held_tf_diag {diag:.3f}, loss "
          f"{float(terms['loss']):.4f}")
    assert mae <= HELD_MAE_MAX, mae

    # ---- the command line: cli train, 3 steps, on a train.txt over the
    # r5 mels
    with tempfile.TemporaryDirectory() as tmp:
        os.symlink(os.path.join(R5, "corpus"), os.path.join(tmp, "corpus"))
        train_txt = os.path.join(tmp, "train.txt")
        hop = cfg.audio.effective_hop
        with open(train_txt, "w", encoding="utf-8") as f:
            for i, t in enumerate(texts[:N_TRAIN]):
                n = len(t) * int(0.06 * cfg.audio.sample_rate) // hop + 1
                f.write(f"corpus|audio-{i}.npy|mel-{i}.npy|l|e|{n * hop}|"
                        f"{n}|{t}|0|{i % 2}|utt{i}.wav|F\n")
        hp = ("tacotron.compute_dtype=bfloat16,audio.trim_silence=false")
        tk.train_launches = 0
        ckpt_dir = cli.main(["--hparams", hp, "train", "--model", "Tacotron",
                             "--input-path", train_txt, "--base-dir", tmp,
                             "--train-steps", "3", "--batch-size",
                             str(TRAIN_BATCH), "--eval-interval", "0"])
        saved = sorted(os.listdir(ckpt_dir))
        curve = open(os.path.join(os.path.dirname(ckpt_dir),
                                  "taco_curve.jsonl")).read().splitlines()
        print(f"cli train --train-steps 3: checkpoints {saved}, "
              f"{len(curve)} curve lines, last {curve[-1]}, train-forward "
              f"launches {tk.train_launches}")
        assert saved == ["ckpt-3.msgpack"] and len(curve) == 3
        assert tk.train_launches == 3
    done(16, t0)
    common = {"route": "cuda", "library_ms": None}
    return [
        dict(common, name="tacotron_teacher_forced_train",
             source="tacotron2_tpu_torch/csrc/decoder_rows.cu",
             replaces="tacotron2_tpu/ops/tacotron_train_kernel.py:118",
             launches=launches[0], max_abs_err=errs["frames max"],
             ms=tf_ms, plain_ms=tf_plain_ms, bound_ms=1e3 * fb[0],
             bound_by=fb[1]),
        dict(common, name="tacotron_bptt",
             source="tacotron2_tpu_torch/csrc/decoder_bwd.cu",
             replaces="tacotron2_tpu/ops/tacotron_train_kernel.py:371",
             launches=launches[1], max_abs_err=bwd_abs, ms=bwd_ms,
             plain_ms=bwd_plain_ms, bound_ms=1e3 * bb[0], bound_by=bb[1])]


# phase 17: the emt_attn variants and their decode steps at most (blocks
# of `fused_block_steps` = 256 on the block route); the kernel is held
# against its plain version over the first block at phase 9's gate
EMT_TYPES = ("simple", "multihead", "style_tokens")
EMT_MAX_STEPS = 512
# phase 18: the paper preset's serving bucket
PAPER_BATCH, PAPER_T_IN, PAPER_STEPS = 2, 64, 64


def _leaves(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: v})
    return out


def emt_weights(cfg, tparams, stats, seed):
    """Random weights for `cfg` from `init_tacotron` (seeded), grafted with
    the r5 checkpoint's tensors where path and shape agree, and LSTM1's
    rows that the r5 model has (prenet, context, hidden) — the emt rows
    stay random. Returns (params, batch_stats, grafted, fresh) with the
    counts of leaves taken from r5 and left random."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import convert
    model = convert.init_tacotron(cfg, torch.Generator().manual_seed(seed),
                                  "cpu")
    params, bstats = convert.tacotron_to_flax(model)
    grafted, fresh = 0, 0
    for tree, r5 in ((params, tparams), (bstats, stats)):
        r5_leaves = _leaves(r5)
        for path, leaf in _leaves(tree).items():
            want = r5_leaves.get(path)
            if want is not None and np.shape(want) == leaf.shape:
                convert.tree_set(tree, path, np.asarray(want, np.float32))
                grafted += 1
            else:
                fresh += 1
    l1 = convert.tree_get(params, "decoder/cell/lstm1/kernel").copy()
    r5l1 = np.asarray(convert.tree_get(tparams, "decoder/cell/lstm1/kernel"))
    U = cfg.tacotron.decoder_lstm_units
    keep = r5l1.shape[0] - U                  # prenet | context rows
    l1[:keep], l1[-U:] = r5l1[:keep], r5l1[-U:]
    convert.tree_set(params, "decoder/cell/lstm1/kernel", l1)
    return params, bstats, grafted, fresh


def emt_phase(texts, ref_list, tparams, stats, seed, base_synth, base_im):
    """Phase 17: Tacotron_emt_attn eval synthesis, the texts' whole corpus
    mels as their references (`ref_list`: Te = ceil(frames / 64) emt
    positions). Returns the `kernels` entries of kernel 3's emt scorers."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
    from tacotron2_tpu_torch.train import checkpoint
    from tacotron2_tpu_torch.train.optim import MaskedAdam
    from tacotron2_tpu_torch.train.tacotron_step import TrainState
    B = len(texts)
    t0 = phase(17, f"(j) emt_attn eval synthesis of the {B} held-out texts "
               f"({', '.join(EMT_TYPES)}), up to {EMT_MAX_STEPS} steps")
    rolled = ref_list[1:] + ref_list[:1]
    entries, timed = [], {}
    for kind in EMT_TYPES:
        cfg = r5_config()
        cfg = cfg.replace(gst=dataclasses.replace(
            cfg.gst, emt_attn=True, emt_attn_type=kind))
        r = cfg.tacotron.outputs_per_step
        params, bstats, ng, nf = emt_weights(cfg, tparams, stats, seed)
        synth = TacotronSynthesizer(cfg, params, bstats, device="cuda",
                                    seed=seed, keep_intermediates=True)
        labels = ([i % cfg.gst.n_emt for i in range(B)]
                  if kind == "style_tokens" else None)
        dk.launches = 0
        torch.cuda.synchronize()
        ts = time.time()
        out = synth.synthesize(texts, ref_list, ref_list,
                               max_steps=EMT_MAX_STEPS, emt_labels=labels)
        torch.cuda.synchronize()
        syn_s = time.time() - ts
        n_launch = dk.launches
        im = synth.intermediates
        emt = im["emt"]
        Bm, T, M = im["memory"].shape
        print(f"{kind}: {ng} tensors from r5, {nf} random; memory width "
              f"{M}, emt memory {tuple(emt.emem.shape)}, context_emt "
              f"{emt.l1_we.shape[0]} wide; route {im['route']}; "
              f"{syn_s:.3f} s; decode launches {n_launch}; stop steps "
              f"{[int(x) for x in out['lengths']]}")
        assert all(np.isfinite(m_).all() for m_ in out["mels"])
        if kind == "style_tokens":
            assert im["route"] == "plain" and n_launch == 0
        else:
            assert im["route"] == "block" and n_launch > 0
        # other emotion references (and labels) move the frames
        moved = []
        for refs_e, lab in ((rolled, labels),) + (
                (((ref_list, [(x + 1) % cfg.gst.n_emt for x in labels]),)
                 if labels else ())):
            out2 = synth.synthesize(texts, refs_e, ref_list,
                                    max_steps=EMT_MAX_STEPS, emt_labels=lab)
            moved.append(max(float(np.abs(
                a_[:min(len(a_), len(b_))] - b_[:min(len(a_), len(b_))]
            ).max()) for a_, b_ in zip(out["mels"], out2["mels"])))
        print(f"{kind}: other emotion references move the mels by up to "
              f"{moved[0]:.3e}" + (f", other labels by {moved[1]:.3e}"
                                   if len(moved) > 1 else ""))
        assert min(moved) > 1e-3, moved
        if kind == "style_tokens":
            continue
        # kernel vs plain over the run's first kf-step block from the zero
        # state, on the run's inputs, dropout multipliers and emt operands
        kf = im["k"]
        args = (synth.dec_params, cfg, im["keys"], im["memory"], im["mask"])
        st0 = dk.init_decoder_state(cfg, Bm, T, M, "cuda")
        drop_k = im["drop"]
        blk = (lambda a=args, s0=st0, d=drop_k, kw=synth.dec_kernel, e=emt:
               dk.decode_block(*a, s0, d, kernel_weights=kw, emt=e))
        got = blk()
        # the rounded function, the emt scorer's roundings too (see
        # replay_gate)
        err = replay_gate(
            f"{kind} over the {kf}-step block",
            lambda st, d, a=args, kw=synth.dec_kernel, e=emt:
            dk.decode_block(*a, st, d, kernel_weights=kw, emt=e),
            lambda st, d, a=args, e=emt: dk.decode_block_plain(*a, st, d, e),
            lambda st, d, a=args, e=emt: dk.decode_block_plain(
                f32_activations(a[0]), *a[1:], st, d, e),
            st0, drop_k, got)
        # the run's first block, repeated bit for bit
        assert np.array_equal(got[1].cpu().numpy(),
                              out["stop_tokens"][:, :kf * r]), \
            f"{kind}: decode kernel is not deterministic"
        timed[kind] = dict(
            launches=n_launch, err=err, blk=blk,
            plain=lambda a=args, e=emt, d=drop_k, s0=st0:
            dk.decode_block_plain(*a, s0, d, e),
            bound=decode_bound_s(synth.dec_params, cfg, Bm, T, M, kf,
                                 Bm * kf, align=True, emt=emt), kf=kf,
            drop=drop_k)
        if kind == "simple":
            cli_case = (cfg, params, bstats)
    # times of one block, in turns: the non-emt block (phase 8's r5 weights
    # on the same texts), simple, multihead, the non-emt block again
    base_cfg = base_synth.cfg
    kf = timed["simple"]["kf"]
    bargs = (base_synth.dec_params, base_cfg, base_im["keys"],
             base_im["memory"], base_im["mask"])
    Bb, Tb, Mb = base_im["memory"].shape
    st_b = dk.init_decoder_state(base_cfg, Bb, Tb, Mb, "cuda")
    drop_b = timed["simple"]["drop"]
    base = lambda: dk.decode_block(*bargs, st_b, drop_b,
                                   kernel_weights=base_synth.dec_kernel)
    base()
    ms = {"base": [cuda_ms(base, 3)]}
    for kind in ("simple", "multihead"):
        ms[kind] = cuda_ms(timed[kind]["blk"], 3)
        timed[kind]["plain_ms"] = cuda_ms(timed[kind]["plain"], 1)
    ms["base"].append(cuda_ms(base, 3))
    print(f"one {kf}-step block at B={Bb}, T_in={Tb}: non-emt kernel "
          f"{ms['base'][0]:.3f} ms then {ms['base'][1]:.3f} ms; simple "
          f"{ms['simple']:.3f} ms (plain {timed['simple']['plain_ms']:.3f} "
          f"ms, bound {1e3 * timed['simple']['bound'][0]:.3f} ms, "
          f"{timed['simple']['bound'][1]}); multihead {ms['multihead']:.3f} "
          f"ms (plain {timed['multihead']['plain_ms']:.3f} ms, bound "
          f"{1e3 * timed['multihead']['bound'][0]:.3f} ms, "
          f"{timed['multihead']['bound'][1]}); emt over non-emt per step: "
          f"simple x{ms['simple'] / np.mean(ms['base']):.3f}, multihead "
          f"x{ms['multihead'] / np.mean(ms['base']):.3f}")
    for kind in ("simple", "multihead"):
        t_ = timed[kind]
        entries.append(dict(
            name=f"3-emt-{kind}", route="cuda",
            source="tacotron2_tpu_torch/csrc/decoder.cu",
            replaces="tacotron2_tpu/ops/tacotron_decoder_kernel.py:508",
            launches=t_["launches"], max_abs_err=t_["err"], ms=ms[kind],
            plain_ms=t_["plain_ms"], bound_ms=1e3 * t_["bound"][0],
            bound_by=t_["bound"][1], library_ms=None))

    # the command line on a checkpoint written by train/checkpoint.py
    cfg, params, bstats = cli_case
    from tacotron2_tpu_torch import convert
    model = convert.tacotron_from_flax(cfg, params, bstats, "cpu")
    ps = list(model.parameters())
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt-0.msgpack")
        checkpoint.save(ckpt, TrainState(step=0, model=model, opt=MaskedAdam(
            cfg, ps, [True] * len(ps))))
        tl = os.path.join(tmp, "texts.txt")
        with open(tl, "w", encoding="utf-8") as f:
            f.write(f"{texts[0]}\n{texts[1]}\n")
        ref_path = os.path.join(tmp, "ref.npy")
        np.save(ref_path, ref_list[0])
        dk.launches = 0
        ts = time.time()
        map_path = cli.main([
            "--hparams", "tacotron.compute_dtype=bfloat16,"
            "audio.trim_silence=false,gst.emt_attn=true,"
            f"gst.emt_attn_type=simple,tacotron.max_iters={EMT_MAX_STEPS}",
            "synthesize", "--model", "Tacotron", "--mode", "eval",
            "--checkpoint", ckpt, "--ref-mel-emt", ref_path, "--text-list",
            tl, "--output-dir", os.path.join(tmp, "out")])
        rows_cli = open(map_path, encoding="utf-8").read().splitlines()
        mels_cli = [np.load(row.split("|")[0]) for row in rows_cli]
        print(f"cli synthesize --hparams gst.emt_attn=true,"
              f"gst.emt_attn_type=simple: {len(rows_cli)} rows, mels "
              f"{[m_.shape for m_ in mels_cli]}, decode launches "
              f"{dk.launches}, {time.time() - ts:.3f} s")
        assert len(rows_cli) == 2 and dk.launches > 0
        assert all(np.isfinite(m_).all() for m_ in mels_cli)
    done(17, t0)
    return entries


def paper_phase(texts, gt, seed):
    """Phase 18: the paper preset (no GST, the MoL head) served through
    TextToWavProgram on random weights."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.config import get_config
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from tacotron2_tpu_torch.text import text_to_sequence
    cfg = get_config("paper")
    Bp = PAPER_BATCH
    t0 = phase(18, f"(k) the paper preset served: B={Bp}, t_in "
               f"{PAPER_T_IN}, {PAPER_STEPS} decode steps, random weights")
    model = convert.init_tacotron(cfg, torch.Generator().manual_seed(seed),
                                  "cpu")
    params, bstats = convert.tacotron_to_flax(model)
    prog = TextToWavProgram(cfg, params, bstats,
                            random_wavenet_tree(cfg, seed), batch=Bp,
                            steps=PAPER_STEPS, t_in=PAPER_T_IN, t_ref=T_REF,
                            device="cuda", seed=seed,
                            keep_intermediates=True)
    assert prog.memory_width == 768, prog.memory_width
    seqs = [text_to_sequence(t[:PAPER_T_IN - 8], cfg.data.cleaners)
            for t in texts[:Bp]]
    ids = np.zeros((Bp, PAPER_T_IN), np.int64)
    for i, sq in enumerate(seqs):
        ids[i, :len(sq)] = sq
    lengths = np.asarray([len(sq) for sq in seqs])
    refs = np.stack([g[:T_REF] for g in gt[:Bp]]).astype(np.float32)
    first = prog._seed
    dk.rows_launches = wk.launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    samples, wav_len, mel, stops, mel_len = prog(ids, lengths, refs, refs)
    torch.cuda.synchronize()
    serve_s = time.time() - ts
    launches = {"tacotron_decoder": dk.rows_launches,
                "wavenet_sampler": wk.launches}
    # the decode kernel against its plain version at this preset's shapes
    # (memory width 768, no GST), on the served call's own inputs
    im = prog.intermediates
    dargs = (prog.dec_params, cfg, im["keys"], im["memory"], im["mask"],
             im["drop"])
    dkw = dict(steps=PAPER_STEPS, early_stop_block=cfg.tacotron.early_stop_block)
    got = dk.decode(*dargs, **dkw, kernel_weights=prog.dec_kernel)
    want = dk.decode_plain(*dargs, **dkw)
    torch.cuda.synchronize()
    errs = {n: float((x - y).abs().max()) for n, x, y in zip(
        ("frames", "stops", "alignments"), got, want)}
    print(f"paper: decode kernel vs plain over {PAPER_STEPS} steps: max "
          f"|diff| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}")
    # phase 9's readings: frames to ~2e-5, stops and alignments to ~1e-6
    # (bf16 weights upcast on both sides, f32 sums in another order)
    assert errs["frames"] <= 1e-3 and errs["stops"] <= 1e-4 \
        and errs["alignments"] <= 1e-4, errs
    # the served call's stop probabilities, repeated bit for bit
    assert torch.equal(got[1], stops), "decode kernel is not deterministic"
    prog._seed = first                    # the same generator seed again
    again = prog(ids, lengths, refs, refs)[0]
    torch.cuda.synchronize()
    samples, wav_len = samples.cpu().numpy(), wav_len.cpu().numpy()
    mel_len = mel_len.cpu().numpy()
    audio_s = float(wav_len.sum()) / cfg.audio.sample_rate
    print(f"paper: memory width {prog.memory_width}, hop "
          f"{prog.hop}, {prog.t_audio} samples a row; {serve_s:.3f} s for "
          f"{Bp} utterances, {audio_s:.4f} s of audio at "
          f"{cfg.audio.sample_rate} Hz, realtime factor "
          f"{audio_s / serve_s:.4f}; mel lengths {mel_len.tolist()}; "
          f"launches {launches}")
    assert all(n > 0 for n in launches.values()), launches
    assert np.isfinite(samples).all() and np.isfinite(mel.cpu()).all()
    assert samples.shape == (Bp, prog.t_audio)
    assert np.array_equal(wav_len, mel_len * prog.hop)
    assert np.array_equal(again.cpu().numpy(), samples), \
        "the paper program is not deterministic"
    done(18, t0)


# phase 19: kernels 5a and 5b against their plain versions on the r5
# EMA weights, the same bf16 operands and dropout masks (one seed), f32
# sums in another order, which moves isolated bf16 roundings (of h, dy, a
# saved activation) by one step; those carry on through the residual
# path. Gates: the skip sum within WN_FWD_RTOL of its largest value and
# its mean difference at most WN_MEAN_SHARE of the plain version's own
# distance from the same stack with f32 weights; each gradient (weights,
# x0, c) on the kernel's saved activations within WN_BWD_RTOL of its
# largest value, the cosine of all of them >= WN_COSINE; reruns bit-exact
WN_FWD_RTOL = 1e-2
WN_MEAN_SHARE = 0.5
WN_BWD_RTOL = 1e-2
WN_COSINE = 0.9999
# the training run: every loss finite, the lowest at least 0.5 under the
# first, the second half's mean under the first five's (the loss from a
# fresh init swings: the f32 layer loop, no kernel in it, swings alike),
# and the first WN_TRAJ_STEPS losses within WN_TRAJ_ATOL of those of the
# same steps through the f32 layer loop
WN_TRAJ_STEPS, WN_TRAJ_ATOL = 12, 1e-2


def stack_bound_s(plan, N, backward):
    """Least seconds of kernel 5a (backward=False) or 5b at N rows: the
    products at the bf16 rate, or with f32 weights at the rate of the
    fastest way to the f32 function, three TF32 products (TF32_FLOPS / 3,
    above the FP32 cores' F32_FLOPS), against the bytes (inputs once,
    outputs once: x0, c, weights; skip and the saved activations, x, tanh
    a and σ b; in the backward those, dskip, dx0, dc and f32 weight
    gradients)."""
    L, C, G, S, Ci, Ch = plan.L, plan.C, plan.G, plan.S, plan.Ci, plan.Ch
    w = L * (3 * C * G + Ci * G + Ch * (S + C))
    wb = 2 if plan.weight_bf16 else 4
    acts = L * N * (C + 2 * Ch) * plan.acts_dtype.itemsize
    if not backward:
        macs = N * w
        nbytes = N * (C + Ci) * 4 + wb * w + N * S * 4 + acts
    else:
        macs = 2 * N * w
        nbytes = (acts + N * (Ci + S) * 4 + wb * w + N * (C + Ci) * 4
                  + 4 * w)
    rate = BF16_FLOPS if plan.weight_bf16 else TF32_FLOPS / 3
    ops_s, bytes_s = 2 * macs / rate, nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


def wavenet_training_phase(wparams, seed):
    """Phase 19: WaveNet training at the r5 shapes. Returns the `kernels`
    entries of kernels 5a and 5b."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli, convert
    from tacotron2_tpu_torch.models.wavenet.model import compute_wavenet_loss
    from tacotron2_tpu_torch.models.wavenet.modules import round_bf16
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.train.tacotron_step import StepTimer
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    cfg = r5_config()
    B, F = len(WN_ROWS), WN_CROP_FRAMES
    t0 = phase(19, f"(l) WaveNet training: B={B} crops of {F * 200} "
               f"samples, {cfg.wavenet.layers} layers, the r5 train split")
    corpus = os.path.join(R5, "corpus")
    pairs = r5_wavenet_rows(corpus, WN_ROWS)
    rng = np.random.default_rng(seed)

    def crops():
        return wavenet_batch(pairs, [int(rng.integers(0, len(m) - F + 1))
                                     for _, m in pairs])

    dev = torch.device("cuda")
    first = crops()

    # ---- (1) kernels 5a and 5b against their plain versions: the r5 EMA
    # weights, the first batch's stack input, dropout from one seed
    model = convert.wavenet_from_flax(cfg, wparams, dev, trainable=True)
    b = WaveNetTrainer(cfg).batch_to_device(first)
    with torch.no_grad():
        c_up = model.upsample(b["c"])
        x0 = model.input_convolution(round_bf16(b["x"]), round_bf16)
        c32 = round_bf16(c_up)
    T = x0.shape[1]
    N = T * B
    x2 = x0.transpose(0, 1).reshape(N, -1).contiguous()
    c2 = c32.transpose(0, 1).reshape(N, -1).contiguous()
    plan = wtk.make_plan(cfg, B)
    plan32 = dataclasses.replace(plan, weight_bf16=False)
    sp = wtk.StackParams(*(t.detach() for t in wtk.extract_stack_params(
        model.residual_blocks, cfg)))
    k_s, k_a = wtk.stack_fwd_cuda(plan, sp, x2, c2, seed)
    p_s, p_a = wtk.stack_fwd_plain(plan, sp, x2, c2, seed)
    f_s, _ = wtk.stack_fwd_plain(plan32, sp, x2, c2, seed)
    # dskip: the loss's own gradient at the kernel's skip sum
    skip = k_s.reshape(T, B, -1).transpose(0, 1).detach().requires_grad_()
    y = model.final_convolution_2(torch.relu(model.final_convolution_1(
        torch.relu(skip))))
    loss = compute_wavenet_loss(y, b["y"], b["input_lengths"], cfg)["loss"]
    dskip = torch.autograd.grad(loss, skip)[0].transpose(0, 1).reshape(
        N, -1).contiguous()
    k_b = wtk.stack_bwd_cuda(plan, sp, k_a, c2, dskip, seed)
    p_b = wtk.stack_bwd_plain(plan, sp, k_a, c2, dskip, seed)
    torch.cuda.synchronize()
    fwd_err = rel_err(k_s, p_s)
    fwd_abs = float((k_s - p_s).abs().max())
    mean_k = float((k_s - p_s).abs().mean())
    mean_f = float((f_s - p_s).abs().mean())
    acts_moved = float((k_a != p_a).float().mean())
    names = list(wtk.StackParams._fields) + ["dx0", "dc"]
    kg, pg = [*k_b[0], k_b[1], k_b[2]], [*p_b[0], p_b[1], p_b[2]]
    bwd_err = {n: rel_err(x, y_) for n, x, y_ in zip(names, kg, pg)}
    bwd_abs = max(float((x - y_).abs().max()) for x, y_ in zip(kg, pg))
    cos = float(torch.nn.functional.cosine_similarity(
        torch.cat([x.flatten() for x in kg]),
        torch.cat([y_.flatten() for y_ in pg]), dim=0))
    print(f"kernel 5a vs plain at N={N}: skip max|d| {fwd_abs:.3e} "
          f"({fwd_err:.2e} of its max), mean {mean_k:.3e} (plain bf16 vs "
          f"f32 weights: {mean_f:.3e}); saved activations moved by a "
          f"rounding step: {acts_moved:.4f}")
    print("kernel 5b vs plain, max|d| / max|plain| per gradient: " + ", ".join(
        f"{n} {v:.2e}" for n, v in bwd_err.items()) + f"; cosine {cos:.7f}")
    assert fwd_err <= WN_FWD_RTOL, fwd_err
    assert mean_k <= WN_MEAN_SHARE * mean_f, (mean_k, mean_f)
    assert max(bwd_err.values()) <= WN_BWD_RTOL, bwd_err
    assert cos >= WN_COSINE, cos
    k_s2, _ = wtk.stack_fwd_cuda(plan, sp, x2, c2, seed)
    k_b2 = wtk.stack_bwd_cuda(plan, sp, k_a, c2, dskip, seed)
    torch.cuda.synchronize()
    exact = torch.equal(k_s, k_s2) and all(
        torch.equal(x, y_) for x, y_ in zip(kg, [*k_b2[0], k_b2[1], k_b2[2]]))
    print(f"reruns bit-exact: {exact}")
    assert exact
    del p_a, p_b, k_b2, f_s

    fwd_ms = cuda_ms(lambda: wtk.stack_fwd_cuda(plan, sp, x2, c2, seed), 3)
    fwd_plain_ms = cuda_ms(lambda: wtk.stack_fwd_plain(plan, sp, x2, c2,
                                                       seed), 1)
    bwd_ms = cuda_ms(lambda: wtk.stack_bwd_cuda(plan, sp, k_a, c2, dskip,
                                                seed), 3)
    bwd_plain_ms = cuda_ms(lambda: wtk.stack_bwd_plain(plan, sp, k_a, c2,
                                                       dskip, seed), 1)
    leaves = [t.clone().requires_grad_() for t in (*sp, x2, c2)]

    def autograd_stack():
        s_, _ = wtk.stack_fwd_plain(plan, wtk.StackParams(*leaves[:8]),
                                    leaves[8], leaves[9], seed)
        torch.autograd.grad(s_, leaves, dskip)

    autograd_stack()        # the warm-up (its buffers allocated)
    autograd_ms = cuda_ms(autograd_stack, 1)
    fb = stack_bound_s(plan, N, backward=False)
    bb = stack_bound_s(plan, N, backward=True)
    print(f"at B={B}, T={T} (N={N}): kernel 5a {fwd_ms:.3f} ms (plain "
          f"{fwd_plain_ms:.3f}, bound {1e3 * fb[0]:.4f} ms, {fb[1]}); "
          f"kernel 5b {bwd_ms:.3f} ms (plain {bwd_plain_ms:.3f}, bound "
          f"{1e3 * bb[0]:.4f} ms, {bb[1]}); autograd of the plain stack, "
          f"forward and backward, {autograd_ms:.3f} ms")
    del k_a, k_b, leaves, dskip
    torch.cuda.empty_cache()

    # ---- (2) 32 steps from init_wavenet: the main path's counts
    trainer = WaveNetTrainer(cfg)
    state = trainer.init_state(torch.Generator().manual_seed(seed), first)
    gen = torch.Generator().manual_seed(seed + 1)
    batches = [crops() for _ in range(WN_STEPS)]
    losses, split = [], {}
    wtk.fwd_launches = wtk.bwd_launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    for i, batch in enumerate(batches):
        timed = 4 <= i < 8
        trainer.timer = StepTimer() if timed else None
        torch.cuda.synchronize()
        t_step = time.time()
        state, m = trainer.train_step(state, batch, gen)
        losses.append(float(m["loss"]))
        if timed:
            for k, v in trainer.timer.totals().items():
                split[k] = split.get(k, 0.0) + v / 4
            split["step (host clock)"] = split.get(
                "step (host clock)", 0.0) + 1e3 * (time.time() - t_step) / 4
    torch.cuda.synchronize()
    train_s = time.time() - ts
    launches = (wtk.fwd_launches, wtk.bwd_launches)
    trainer.timer = None
    print(f"{WN_STEPS} train steps from init_wavenet: {train_s:.3f} s; "
          f"kernel launches 5a {launches[0]}, 5b {launches[1]}; loss "
          + " ".join(f"{x:.4f}" for x in losses))
    print("ms per step (mean of steps 5-8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    assert launches == (WN_STEPS, WN_STEPS), launches
    # the same steps through the layer loop in f32 (no stack kernels;
    # cuDNN and autograd): the trajectories agree until they part where
    # bf16 roundings grow, and the loss's later swings are the model's
    ref_cfg = cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, use_fused_train_stack=False, compute_dtype="float32"))
    ref = WaveNetTrainer(ref_cfg)
    ref_state = ref.init_state(torch.Generator().manual_seed(seed), first)
    ref_gen = torch.Generator().manual_seed(seed + 1)
    ref_losses = [float(ref.train_step(ref_state, b_, ref_gen)[1]["loss"])
                  for b_ in batches[:WN_TRAJ_STEPS]]
    traj = max(abs(x - y_) for x, y_ in zip(losses, ref_losses))
    print(f"first {WN_TRAJ_STEPS} losses against the f32 layer loop's: "
          f"max |difference| {traj:.3e}")
    assert all(np.isfinite(losses)), losses
    assert traj <= WN_TRAJ_ATOL, (losses, ref_losses)
    assert min(losses) < losses[0] - 0.5, losses
    assert np.mean(losses[WN_STEPS // 2:]) < np.mean(losses[:5]), losses
    del ref_state

    # ---- (3) the r5 EMA checkpoint's eval loss on the fixed crops, f32
    # and the r5 config's bf16 stack, against the JAX package's values
    held = r5_parity_batch(corpus)
    for dt, want, rtol in (("float32", R5_EMA_LOSS_JAX, R5_EMA_RTOL),
                           ("bfloat16", R5_EMA_LOSS_JAX_BF16,
                            R5_EMA_BF16_RTOL)):
        c_ = cfg.replace(wavenet=dataclasses.replace(cfg.wavenet,
                                                     compute_dtype=dt))
        tr = WaveNetTrainer(c_)
        st = tr.init_state(model=convert.wavenet_from_flax(
            c_, wparams, dev, trainable=True))
        got = float(tr.eval_step(st, held)[1]["loss"])
        print(f"r5 EMA eval_step, {dt}: loss {got:.6f} (JAX on the CPU "
              f"{want:.6f}; gate {rtol:g} relative)")
        assert abs(got - want) <= rtol * abs(want), (dt, got, want)

    # ---- (4) the command lines: train --model WaveNet (3 steps), its
    # checkpoint through synthesize --model WaveNet; train --model
    # Tacotron-2 (2 steps a stage) on the 16 rows
    hp = ("tacotron.compute_dtype=bfloat16,wavenet.compute_dtype=bfloat16,"
          "wavenet.use_fused_train_stack=true,audio.trim_silence=false,"
          f"train.max_time_steps={F * 200}")
    with tempfile.TemporaryDirectory() as tmp:
        map_txt = os.path.join(tmp, "map.txt")
        with open(map_txt, "w", encoding="utf-8") as f:
            for i in WN_ROWS:
                a = os.path.join(corpus, "audio", f"audio-{i}.npy")
                m = os.path.join(corpus, "mels", f"mel-{i}.npy")
                f.write(f"{a}|{m}|{m}|0|text\n")
        wtk.fwd_launches = 0
        ckpt_dir = cli.main(["--hparams", hp, "train", "--model", "WaveNet",
                             "--input-path", map_txt, "--base-dir", tmp,
                             "--train-steps", "3", "--batch-size", str(B),
                             "--eval-interval", "0"])
        saved = sorted(os.listdir(ckpt_dir))
        print(f"cli train --model WaveNet --train-steps 3: checkpoints "
              f"{saved}, stack forward launches {wtk.fwd_launches}")
        assert saved == ["ckpt-3.msgpack"] and wtk.fwd_launches == 3
        mel = os.path.join(tmp, "mel-8.npy")
        np.save(mel, pairs[0][1][:8])
        one = os.path.join(tmp, "one.txt")
        with open(one, "w", encoding="utf-8") as f:
            f.write(f"a.npy|{mel}|{mel}|0|text\n")
        out = cli.main(["--hparams", hp, "synthesize", "--model", "WaveNet",
                        "--wavenet-checkpoint",
                        os.path.join(ckpt_dir, saved[0]), "--mels-map", one,
                        "--output-dir", os.path.join(tmp, "out")])
        with wave.open(out[0]) as w:
            n_wav = w.getnframes()
        print(f"synthesize --model WaveNet on its checkpoint: {n_wav} "
              f"samples for 8 frames")
        assert n_wav == 8 * 200

        os.symlink(corpus, os.path.join(tmp, "corpus"))
        train_txt = os.path.join(tmp, "train.txt")
        texts = corpus_texts()
        with open(train_txt, "w", encoding="utf-8") as f:
            for i in WN_ROWS:
                n = len(pairs[i][1])
                f.write(f"corpus|audio-{i}.npy|mel-{i}.npy|l|e|{n * 200}|"
                        f"{n}|{texts[i]}|0|{i % 2}|utt{i}.wav|F\n")
        base = os.path.join(tmp, "t2")
        wtk.fwd_launches = 0
        wave_dir = cli.main(["--hparams", hp, "train", "--model",
                             "Tacotron-2", "--input-path", train_txt,
                             "--base-dir", base, "--train-steps", "2",
                             "--batch-size", str(B), "--wavenet-batch-size",
                             "8", "--eval-interval", "0"])
        state_log = open(os.path.join(base, "state_log")).read()
        gta = open(os.path.join(base, "tacotron_output", "gta",
                                "map.txt")).read().splitlines()
        print(f"cli train --model Tacotron-2: state_log '{state_log}', "
              f"{len(gta)} GTA rows, WaveNet checkpoints "
              f"{sorted(os.listdir(wave_dir))}, stack forward launches "
              f"{wtk.fwd_launches}")
        assert state_log == "1 1 1" and len(gta) == B
        assert os.listdir(wave_dir) == ["ckpt-2.msgpack"]
        assert wtk.fwd_launches == 2
    done(19, t0)
    common = {"route": "cuda", "library_ms": None,
              "source": "tacotron2_tpu_torch/csrc/wavenet_train.cu"}
    return [
        dict(common, name="wavenet_stack_fwd",
             replaces="tacotron2_tpu/ops/wavenet_train_kernel.py:133",
             launches=launches[0], max_abs_err=fwd_abs, ms=fwd_ms,
             plain_ms=fwd_plain_ms, bound_ms=1e3 * fb[0], bound_by=fb[1]),
        dict(common, name="wavenet_stack_bwd",
             replaces="tacotron2_tpu/ops/wavenet_train_kernel.py:261",
             launches=launches[1], max_abs_err=bwd_abs, ms=bwd_ms,
             plain_ms=bwd_plain_ms, bound_ms=1e3 * bb[0], bound_by=bb[1])]


# phase 20: the decode kernels' envelope on the r5 weights. The f32
# kernels against their plain versions: the same f32 function in another
# sum order, nothing rounded, so every field over the first 256-step block
# is held to ENV_F32_ATOL, the cell states to ENV_F32_ATOL of their scale,
# max(1, their largest magnitude) (they reach a few hundred over a block,
# and a relative sum-order difference grows with them: the first readings
# were 3.2e-4 / 3.8e-4 on c1 / c2 of the long inputs' block at scale ~230,
# frames 1.9e-5, every other field under 1.4e-5). Control: the bf16
# kernel on the same inputs must fail that gate. Smoothing with the r5
# config's bf16 decode weights: `replay_gate`. Kernel 4a in f32 against
# its plain version: every output and residual within RES_TOL, the cell
# states within RES_TOL of their scale; kernel 4b within BWD_RTOL of each
# gradient's scale, as phase 16.
ENV_F32_ATOL = 1e-4
CELL_STATES = ("c1", "c2", "state.c1", "state.c2")
ENV_BLOCK = 256
ENV_TRAIN_STEPS, ENV_SMOOTH_STEPS = 8, 4


def with_tacotron(cfg, **tc):
    return cfg.replace(tacotron=dataclasses.replace(cfg.tacotron, **tc))


def f32_gate(name, got, want, tol, control=None):
    """Every field of `got` ({field: tensor}) within its tolerance against
    `want` (`tol`, one float or {field: float}; the cell states' times
    max(1, the plain field's largest magnitude)); prints the readings and
    returns the largest difference. `control` ({field: tensor}, optional)
    must fail the same gate."""
    def check(x_of):
        rows, bad, worst = [], [], 0.0
        for n, x in x_of.items():
            y = want[n].float()
            err = float((x.float() - y).abs().max())
            scale = (max(1.0, float(y.abs().max())) if n in CELL_STATES
                     else 1.0)
            t = (tol[n] if isinstance(tol, dict) else tol) * scale
            worst = max(worst, err)
            rows.append(f"{n} {err:.2e} (limit {t:.2g})")
            if not err <= t:  # NaN fails
                bad.append(n)
        return rows, bad, worst

    rows, bad, worst = check(got)
    print(f"{name}: " + ", ".join(rows))
    assert not bad, (name, bad)
    if control is not None:
        c_rows, c_bad, _ = check(control)
        print(f"{name}, control (the bf16 kernel on the same inputs): "
              + ", ".join(c_rows) + f"; fails on {c_bad}")
        assert c_bad, f"{name}: the gate does not tell the control apart"
    return worst


def envelope_phase(cfg, tparams, stats, prog, texts, gt, long_texts, out8,
                   seed):
    """Phase 20: f32 decode and train weights and smoothing attention at
    the r5 width, on the r5 weights, through every entry point; the bf16
    rounding repair's size. Returns the `kernels` entries of kernels 1 and
    3 in f32 and under smoothing, and 4a (train mode) and 4b in f32."""
    import glob
    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.convert import load_tacotron
    from tacotron2_tpu_torch.eval.convergence import (batch_from_rows,
                                                      masked_mel_mae)
    from tacotron2_tpu_torch.models.tacotron.decoder import (
        WHOLE, drop_masks, teacher_inputs, zoneout_masks)
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
    from tacotron2_tpu_torch.train.tacotron_step import (StepTimer,
                                                         TacotronTrainer)
    t0 = phase(20, "(m) the decode kernels' envelope: f32 decode and train "
               "weights, smoothing attention, on the r5 weights")
    tc, a = cfg.tacotron, cfg.audio
    r, K = tc.outputs_per_step, tc.early_stop_block
    B = len(texts)
    refs = [g[:T_REF] for g in gt]
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    common = {"route": "cuda", "library_ms": None}
    entries = []

    # ---- (0) the bf16 rounding repair on the served call's inputs: the
    # kernel and its plain version round what the TPU kernels round; the
    # same bf16-valued weights without those roundings
    im = prog.intermediates
    sargs = (im["keys"], im["memory"], im["mask"], im["drop"])
    dkw = dict(steps=MAX_STEPS, early_stop_block=K, emit_alignments=False)
    cfg32 = with_tacotron(cfg, fused_decoder_dtype="float32",
                          fused_train_dtype="float32")
    f_k, s_k, _ = dk.decode(prog.dec_params, cfg, *sargs, **dkw,
                            kernel_weights=prog.dec_kernel)
    f_u, _, _ = dk.decode_plain(tk.cast_params(prog.dec_params,
                                               torch.float32), cfg32, *sargs,
                                **dkw)
    sync()
    n32 = 32 * r
    d = (f_k[:, :n32] - f_u[:, :n32]).abs()
    fired = first_fire(s_k.cpu().numpy(), r, K, MAX_STEPS)
    n_stop = min((f for f, _ in fired if f is not None),
                 default=MAX_STEPS) * r
    d_all = (f_k[:, :n_stop] - f_u[:, :n_stop]).abs()
    print(f"rounding repair: the served bf16 decode (kernel) against the "
          f"same weights without the TPU kernels' roundings: frames over "
          f"the first 32 steps max {float(d.max()):.3e} mean "
          f"{float(d.mean()):.3e}; over the {n_stop // r} steps before the "
          f"first stop max {float(d_all.max()):.3e} mean "
          f"{float(d_all.mean()):.3e}")

    # ---- (1) f32 eval synthesis of the held-out texts: kernel 1 in f32
    synth32 = TacotronSynthesizer(cfg32, tparams, stats, device="cuda",
                                  seed=1234, keep_intermediates=True)
    assert synth32.dec_kernel.l1_w.dtype == torch.float32
    dk.rows_launches = 0
    sync()
    ts = time.time()
    out32 = synth32.synthesize(texts, refs, refs, max_steps=MAX_STEPS)
    sync()
    eval32_s = time.time() - ts
    n1 = dk.rows_launches
    im1 = dict(synth32.intermediates)
    print(f"f32 eval: {eval32_s:.3f} s for {B} utterances; route "
          f"{im1['route']}; decode launches {n1}")
    assert im1["route"] == "fused" and n1 > 0
    diffs = []
    for b in range(B):
        L, mel_b = out32["lengths"][b], out32["mels"][b]
        dg = diagonality(out32["alignments"][b])
        c = float(np.corrcoef(time_resample(mel_b, len(gt[b])).ravel(),
                              gt[b].ravel())[0, 1])
        n = min(len(mel_b), len(out8["mels"][b]))
        diffs.append(float(np.abs(mel_b[:n] - out8["mels"][b][:n]).mean()))
        print(f"f32 row {HELD_ROWS[b]}: stop step {L} (bf16 "
              f"{out8['lengths'][b]}) diagonality {dg:.4f} free-run mel "
              f"corr {c:.4f}; mean |f32 - bf16 mel| over {n} frames "
              f"{diffs[-1]:.4f}")
        assert L < MAX_STEPS * r, f"row {b}: stop never fired"
        assert dg >= 0.95 and c >= 0.9, (b, dg, c)
        assert np.isfinite(mel_b).all()
    print(f"f32 vs bf16 eval mels: mean |difference| per row "
          f"{min(diffs):.4f}-{max(diffs):.4f}")
    d0 = im1["drop"][:, :ENV_BLOCK].contiguous()
    eargs = (synth32.dec_params, cfg32, im1["keys"], im1["memory"],
             im1["mask"], d0)
    got = dk.decode(*eargs, steps=ENV_BLOCK, kernel_weights=synth32.dec_kernel)
    want = dk.decode_plain(*eargs, steps=ENV_BLOCK)
    ctl = dk.decode(prog.dec_params, cfg, *eargs[2:], steps=ENV_BLOCK,
                    kernel_weights=prog.dec_kernel)
    sync()
    err1 = f32_gate(f"kernel 1 f32 vs plain over the first {ENV_BLOCK} "
                    "steps", state_dict(got), state_dict(want), ENV_F32_ATOL,
                    control=state_dict(ctl))
    _, s_re, _ = dk.decode(synth32.dec_params, cfg32, im1["keys"],
                           im1["memory"], im1["mask"], im1["drop"],
                           steps=MAX_STEPS, early_stop_block=K,
                           kernel_weights=synth32.dec_kernel)
    assert np.array_equal(s_re.cpu().numpy(), out32["stop_tokens"]), \
        "f32 decode kernel is not deterministic"
    # times on the served call's inputs (phase 6's), bf16 and f32 in turns
    dp32, kw32 = synth32.dec_params, synth32.dec_kernel
    _, s32, _ = dk.decode(dp32, cfg32, *sargs, **dkw, kernel_weights=kw32)
    run32 = sum(run for _, run in first_fire(s32.cpu().numpy(), r, K,
                                             MAX_STEPS))
    t_b = lambda: dk.decode(prog.dec_params, cfg, *sargs, **dkw,
                            kernel_weights=prog.dec_kernel)
    t_f = lambda: dk.decode(dp32, cfg32, *sargs, **dkw, kernel_weights=kw32)
    turns = [cuda_ms(fn, 3) for fn in (t_b, t_f, t_f, t_b)]
    ms1 = 0.5 * (turns[1] + turns[2])
    plain1 = cuda_ms(lambda: dk.decode_plain(dp32, cfg32, *sargs, **dkw), 1)
    T, M = im["memory"].shape[1:]
    bnd1 = decode_bound_s(dp32, cfg32, B, T, M, MAX_STEPS, run32, align=False)
    print(f"kernel 1 at B={B}, T_in={T}, {MAX_STEPS} steps ({run32} "
          f"row-steps run): f32 {ms1:.3f} ms, bf16 "
          f"{0.5 * (turns[0] + turns[3]):.3f} ms in the same turns "
          f"(bf16, f32, f32, bf16: {', '.join(f'{x:.3f}' for x in turns)}); "
          f"f32 plain {plain1:.3f} ms, bound {1e3 * bnd1[0]:.4f} ms "
          f"({bnd1[1]}); {weight_rereads(dp32, -(-run32 // B))}")
    entries.append(dict(
        common, name="tacotron_decoder_f32",
        source="tacotron2_tpu_torch/csrc/decoder_rows.cu",
        replaces="tacotron2_tpu/ops/tacotron_decoder_kernel.py:842",
        launches=n1, max_abs_err=err1, ms=ms1, plain_ms=plain1,
        bound_ms=1e3 * bnd1[0], bound_by=bnd1[1]))

    # ---- (2) f32 long inputs: kernel 3 in f32, its first block against
    # the plain block decode
    dk.rows_launches = 0
    out9 = synth32.synthesize(long_texts, refs[:4], refs[:4])
    sync()
    n3 = dk.rows_launches
    im3 = dict(synth32.intermediates)
    B9, T9, M9 = im3["memory"].shape
    kf = im3["k"]
    assert im3["route"] == "block" and T9 > 256 and n3 > 0
    assert all(np.isfinite(x).all() for x in out9["mels"])
    st0 = dk.init_decoder_state(cfg32, B9, T9, M9, "cuda")
    bargs = (dp32, cfg32, im3["keys"], im3["memory"], im3["mask"])
    got = dk.decode_block(*bargs, st0, im3["drop"], kernel_weights=kw32)
    want = dk.decode_block_plain(*bargs, st0, im3["drop"])
    sync()
    print(f"f32 long: {B9} texts, T_in {T9}, stop steps "
          f"{out9['lengths']}, decode launches {n3}")
    err3 = f32_gate(f"kernel 3 f32 vs plain over one {kf}-step block",
                    state_dict(got), state_dict(want), ENV_F32_ATOL)
    ms3 = cuda_ms(lambda: dk.decode_block(*bargs, st0, im3["drop"],
                                          kernel_weights=kw32), 3)
    plain3 = cuda_ms(lambda: dk.decode_block_plain(*bargs, st0, im3["drop"]),
                     1)
    bnd3 = decode_bound_s(dp32, cfg32, B9, T9, M9, kf, B9 * kf, align=True)
    print(f"kernel 3 f32, one {kf}-step block at B={B9}, T_in={T9}: "
          f"{ms3:.3f} ms, plain {plain3:.3f} ms, bound "
          f"{1e3 * bnd3[0]:.4f} ms ({bnd3[1]}); {weight_rereads(dp32, kf)}")
    entries.append(dict(
        common, name="tacotron_decoder_block_f32",
        source="tacotron2_tpu_torch/csrc/decoder_rows.cu",
        replaces="tacotron2_tpu/ops/tacotron_decoder_kernel.py:321",
        launches=n3, max_abs_err=err3, ms=ms3, plain_ms=plain3,
        bound_ms=1e3 * bnd3[0], bound_by=bnd3[1]))

    # ---- (3) smoothing eval synthesis on the r5 weights (bf16 decode),
    # both routes; r5 was trained with the softmax: no quality gate
    cfg_s = with_tacotron(cfg, smoothing=True)
    synth_s = TacotronSynthesizer(cfg_s, tparams, stats, device="cuda",
                                  seed=1234, keep_intermediates=True)
    dps, kws = synth_s.dec_params, synth_s.dec_kernel
    dk.rows_launches = 0
    out_s = synth_s.synthesize(texts, refs, refs, max_steps=MAX_STEPS)
    sync()
    n1s = dk.rows_launches
    ims = dict(synth_s.intermediates)
    assert ims["route"] == "fused" and n1s > 0
    assert all(np.isfinite(x).all() for x in out_s["mels"])
    diag_s = [diagonality(x) for x in out_s["alignments"]]
    sa = (dps, cfg_s, ims["keys"], ims["memory"], ims["mask"])
    d0 = ims["drop"][:, :ENV_BLOCK].contiguous()
    got = dk.decode(*sa, d0, steps=ENV_BLOCK, kernel_weights=kws)
    print(f"smoothing eval: stop steps {out_s['lengths']}, launches {n1s}, "
          f"diagonality {', '.join(f'{x:.3f}' for x in diag_s)}")
    st_z = dk.init_decoder_state(cfg_s, B, *ims["memory"].shape[1:], "cuda")
    dps_u = f32_activations(dps)
    err1s = replay_gate(
        f"kernel 1 smoothing over the first {ENV_BLOCK} steps",
        lambda st, d: dk.decode_block(*sa, st, d, casts=WHOLE,
                                      kernel_weights=kws),
        lambda st, d: dk.decode_block_plain(*sa, st, d, casts=WHOLE),
        lambda st, d: dk.decode_block_plain(dps_u, *sa[1:], st, d), st_z,
        d0, got)
    _, s_re, _ = dk.decode(dps, cfg_s, ims["keys"], ims["memory"],
                           ims["mask"], ims["drop"], steps=MAX_STEPS,
                           early_stop_block=K, kernel_weights=kws)
    assert np.array_equal(s_re.cpu().numpy(), out_s["stop_tokens"]), \
        "smoothing decode kernel is not deterministic"
    dk.rows_launches = 0
    out_sl = synth_s.synthesize(long_texts, refs[:4], refs[:4])
    sync()
    n3s = dk.rows_launches
    iml = dict(synth_s.intermediates)
    assert iml["route"] == "block" and n3s > 0
    assert all(np.isfinite(x).all() for x in out_sl["mels"])
    st0 = dk.init_decoder_state(cfg_s, B9, T9, M9, "cuda")
    la = (dps, cfg_s, iml["keys"], iml["memory"], iml["mask"])
    got = dk.decode_block(*la, st0, iml["drop"], kernel_weights=kws)
    print(f"smoothing long: stop steps {out_sl['lengths']}, launches "
          f"{n3s}, diagonality " + ", ".join(
              f"{diagonality(x):.3f}" for x in out_sl["alignments"]))
    err3s = replay_gate(
        f"kernel 3 smoothing over one {kf}-step block",
        lambda st, d: dk.decode_block(*la, st, d, kernel_weights=kws),
        lambda st, d: dk.decode_block_plain(*la, st, d),
        lambda st, d: dk.decode_block_plain(dps_u, *la[1:], st, d), st0,
        iml["drop"], got)
    ssa = (dps, cfg_s, *sargs)
    _, s_s, _ = dk.decode(*ssa, **dkw, kernel_weights=kws)
    run_s = sum(run for _, run in first_fire(s_s.cpu().numpy(), r, K,
                                             MAX_STEPS))
    ms1s = cuda_ms(lambda: dk.decode(*ssa, **dkw, kernel_weights=kws), 3)
    plain1s = cuda_ms(lambda: dk.decode_plain(*ssa, **dkw), 1)
    bnd1s = decode_bound_s(dps, cfg_s, B, T, M, MAX_STEPS, run_s,
                           align=False)
    ms3s = cuda_ms(lambda: dk.decode_block(*la, st0, iml["drop"],
                                           kernel_weights=kws), 3)
    plain3s = cuda_ms(lambda: dk.decode_block_plain(*la, st0, iml["drop"]),
                      1)
    bnd3s = decode_bound_s(dps, cfg_s, B9, T9, M9, kf, B9 * kf, align=True)
    print(f"smoothing times: kernel 1 on the served inputs ({run_s} "
          f"row-steps) {ms1s:.3f} ms, plain {plain1s:.3f} ms, bound "
          f"{1e3 * bnd1s[0]:.4f} ms; kernel 3, one {kf}-step block at "
          f"B={B9}, T_in={T9}: {ms3s:.3f} ms, plain {plain3s:.3f} ms, bound "
          f"{1e3 * bnd3s[0]:.4f} ms")
    for name, rep, n, err, ms, pl, bnd in (
            ("tacotron_decoder_smoothing", 842, n1s, err1s, ms1s, plain1s,
             bnd1s),
            ("tacotron_decoder_block_smoothing", 321, n3s, err3s, ms3s,
             plain3s, bnd3s)):
        entries.append(dict(
            common, name=name, source="tacotron2_tpu_torch/csrc/decoder_rows.cu",
            replaces=f"tacotron2_tpu/ops/tacotron_decoder_kernel.py:{rep}",
            launches=n, max_abs_err=err, ms=ms, plain_ms=pl,
            bound_ms=1e3 * bnd[0], bound_by=bnd[1]))

    # ---- (4) f32 serve and GTA: TextToWavProgram (Griffin-Lim) and
    # synthesize(gta=True) on the first 32 train texts through kernel 4a's
    # eval mode in f32
    prog32 = TextToWavProgram(cfg32, tparams, stats, None, batch=B,
                              steps=MAX_STEPS, t_in=T_IN, t_ref=T_REF,
                              device="cuda", seed=1234,
                              vocoder="griffin_lim")
    assert prog32.dec_kernel.l1_w.dtype == torch.float32
    dk.rows_launches = 0
    wavs = prog32.synthesize(texts, refs, refs)
    sync()
    print(f"f32 TextToWavProgram(vocoder=griffin_lim): decode launches "
          f"{dk.rows_launches}, wav samples {[len(w) for w in wavs]}")
    assert dk.rows_launches > 0 and all(len(w) and np.isfinite(w).all()
                                   for w in wavs)
    train_texts = corpus_texts()[:GTA_BATCH]
    train_mels = [np.load(os.path.join(R5, "corpus", "mels", f"mel-{i}.npy"))
                  for i in range(GTA_BATCH)]
    tk.launches = dk.launches = 0
    gta32 = synth32.synthesize(train_texts, [m[:T_REF] for m in train_mels],
                               [m[:T_REF] for m in train_mels],
                               mel_targets=train_mels, gta=True)
    sync()
    assert synth32.intermediates["route"] == "teacher_forced"
    assert synth32.teacher_forced_weights()[1].l1_w.dtype == torch.float32
    mae32 = float(np.mean([np.abs(g[:len(t)] - t[:len(g)]).mean()
                           for g, t in zip(gta32["mels"], train_mels)]))
    print(f"f32 GTA of {GTA_BATCH} train texts: teacher-forced launches "
          f"{tk.launches} (csrc/decoder_rows.cu; csrc/decoder.cu "
          f"{dk.launches}), mel MAE vs ground truth {mae32:.4f} (phase 15's "
          f"gate {GTA_MAE_MAX})")
    assert tk.launches == 1 and dk.launches == 0 and mae32 <= GTA_MAE_MAX, \
        mae32

    # ---- (5) f32 training at phase 16's shapes: kernels 4a and 4b in f32
    cfg_t = with_tacotron(train_config(), fused_train_dtype="float32")
    ctexts = corpus_texts()
    mel_dir = os.path.join(R5, "corpus", "mels")
    rows = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
            for i, t in enumerate(ctexts)]
    batch = lambda rs: batch_from_rows(rs, mel_dir, cfg_t,
                                       pad_text_to=PAD_TEXT,
                                       pad_mel_to=PAD_MEL)
    first = batch(rows[:TRAIN_BATCH])
    model = load_tacotron(Tacotron(cfg_t), tparams, stats).to(dev)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in first.items()}
    with torch.no_grad():
        keys, memory, mask, _, _ = model.synthesis_memory_ext(
            tb["inputs"], tb["input_lengths"], tb["ref_mel_emt"],
            tb["ref_mel_spk"])
        dp = tk.cast_params(tk.extract_params_traced(model.decoder, cfg_t),
                            torch.float32)
    kw = dk.pack_weights(dp)
    g = torch.Generator(device=dev).manual_seed(seed)
    Bt, Tt, Mt = memory.shape
    S = PAD_MEL // r
    teacher = teacher_inputs(tb["mel_targets"], r)
    coins = (torch.rand(S, generator=g, device=dev) < 0.5).to(torch.int32)
    drop = drop_masks(cfg_t, Bt, S, g, dev)
    zmask = zoneout_masks(cfg_t, Bt, S, g, dev)
    fargs = (dp, cfg_t, keys, memory, mask, teacher, coins, drop, zmask)
    dk.launches = tk.train_launches = 0
    k_f = tk.teacher_forced_train_fwd(*fargs, kernel_weights=kw)
    p_f = tk.teacher_forced_train_fwd_plain(*fargs)
    sync()
    print(f"kernel 4a train mode f32: launches rows kernel "
          f"{tk.train_launches} ({-(-Bt // 8)} clusters of {kw.rows.cs} "
          f"CTAs), csrc/decoder.cu {dk.launches}")
    assert (tk.train_launches, dk.launches) == (1, 0)
    f32_gate("kernel 4a train mode f32 vs plain", {n: k_f[3][n] for n in
             RES_TOL}, {n: p_f[3][n] for n in RES_TOL}, RES_TOL)
    f_err = {"frames": float((k_f[0] - p_f[0]).abs().max())}
    res = k_f[3]
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    FO = res["out"].shape[-1]
    dout = torch.randn(Bt, S, FO, generator=gd, device=dev) * 1e-3
    dalign = torch.randn(Bt, S, Tt, generator=gd, device=dev) * 1e-3
    b_args = (dp, cfg_t, res, keys, memory, mask, coins, drop, zmask, dout,
              dalign)
    k_b = tk.teacher_forced_bwd(*b_args, kernel_weights=kw)
    p_b = tk.teacher_forced_bwd_plain(*b_args)
    k_w = tk.weight_grads(cfg_t, dp, res, k_b, teacher, coins)
    p_w = tk.weight_grads(cfg_t, dp, res, p_b, teacher, coins)
    sync()
    b_err = {n: rel_err(k_b[n], p_b[n]) for n in p_b}
    b_err.update({f"d{n}": rel_err(x, y) for n, x, y in zip(
        dp._fields, k_w[0], p_w[0])})
    print("kernel 4b f32 vs plain, max |difference| / max |plain|: "
          + ", ".join(f"{n} {v:.2e}" for n, v in b_err.items()))
    assert max(b_err.values()) <= BWD_RTOL, b_err
    b_abs = max(float((k_b[n] - p_b[n]).abs().max()) for n in p_b)
    tf_ms = cuda_ms(lambda: tk.teacher_forced_train_fwd(
        *fargs, kernel_weights=kw), 3)
    tf_plain = cuda_ms(lambda: tk.teacher_forced_train_fwd_plain(*fargs), 1)
    bw_ms = cuda_ms(lambda: tk.teacher_forced_bwd(*b_args, kernel_weights=kw),
                    3)
    bw_plain = cuda_ms(lambda: tk.teacher_forced_bwd_plain(*b_args), 1)
    fb = train_bound_s(dp, cfg_t, Bt, Tt, Mt, S, backward=False)
    bb = train_bound_s(dp, cfg_t, Bt, Tt, Mt, S, backward=True)
    print(f"f32 at B={Bt}, T_in={Tt}, {S} steps: kernel 4a train "
          f"{tf_ms:.3f} ms (plain {tf_plain:.3f}, bound {1e3 * fb[0]:.4f} "
          f"ms, {fb[1]}); kernel 4b {bw_ms:.3f} ms (plain {bw_plain:.3f}, "
          f"bound {1e3 * bb[0]:.4f} ms, {bb[1]}); each: "
          f"{weight_rereads(dp, S)}")
    del k_f, p_f, k_b, p_b, k_w, p_w, res
    trainer = TacotronTrainer(cfg_t)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    n_b = N_TRAIN // TRAIN_BATCH
    order = [int(i) for i in rng.permutation(n_b)]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    losses, split = [], {}
    tk.train_launches = tk.bwd_launches = 0
    for i in range(ENV_TRAIN_STEPS):
        timed = i >= ENV_TRAIN_STEPS // 2
        trainer.timer = StepTimer() if timed else None
        sync()
        t_step = time.time()
        state, m = trainer.train_step(
            state, batch(rows[order[i % n_b] * TRAIN_BATCH:
                              (order[i % n_b] + 1) * TRAIN_BATCH]), gen)
        losses.append(float(m["loss"]))
        if timed:
            k = ENV_TRAIN_STEPS - ENV_TRAIN_STEPS // 2
            for name, v in trainer.timer.totals().items():
                split[name] = split.get(name, 0.0) + v / k
            split["step (host clock)"] = split.get(
                "step (host clock)", 0.0) + 1e3 * (time.time() - t_step) / k
    trainer.timer = None
    launches = (tk.train_launches, tk.bwd_launches)
    print(f"{ENV_TRAIN_STEPS} f32 train steps from init_tacotron: launches "
          f"4a {launches[0]}, 4b {launches[1]}; loss "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"f32 ms per step (mean of steps {ENV_TRAIN_STEPS // 2 + 1}-"
          f"{ENV_TRAIN_STEPS}): " + ", ".join(
              f"{k} {v:.3f}" for k, v in split.items()))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert launches == (ENV_TRAIN_STEPS, ENV_TRAIN_STEPS), launches
    state = TacotronTrainer(cfg_t).init_state(model=model)
    held = batch(rows[N_TRAIN:])
    tk.launches = 0
    out, _ = trainer.eval_step(state, held,
                               torch.Generator(device=dev).manual_seed(123))
    mae = masked_mel_mae(out["mel_outputs"].float().cpu().numpy(), held)
    print(f"r5 checkpoint eval_step through kernel 4a's eval mode in f32 "
          f"({tk.launches} launch): masked_mel_mae {mae:.4f} (gate "
          f"{HELD_MAE_MAX})")
    assert tk.launches == 1 and mae <= HELD_MAE_MAX, mae
    entries.append(dict(
        common, name="tacotron_teacher_forced_train_f32",
        source="tacotron2_tpu_torch/csrc/decoder_rows.cu",
        replaces="tacotron2_tpu/ops/tacotron_train_kernel.py:118",
        launches=launches[0], max_abs_err=f_err["frames"], ms=tf_ms,
        plain_ms=tf_plain, bound_ms=1e3 * fb[0], bound_by=fb[1]))
    entries.append(dict(
        common, name="tacotron_bptt_f32",
        source="tacotron2_tpu_torch/csrc/decoder_bwd.cu",
        replaces="tacotron2_tpu/ops/tacotron_train_kernel.py:371",
        launches=launches[1], max_abs_err=b_abs, ms=bw_ms,
        plain_ms=bw_plain, bound_ms=1e3 * bb[0], bound_by=bb[1]))
    del model, state, trainer

    # ---- (6) smoothing training: the plain teacher-forced route, no
    # kernel 4a/4b launch
    cfg_ts = with_tacotron(train_config(), smoothing=True)
    trainer = TacotronTrainer(cfg_ts)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    tk.train_launches = tk.bwd_launches = tk.launches = 0
    losses = []
    sync()
    ts = time.time()
    for i in range(ENV_SMOOTH_STEPS):
        j = order[i % n_b]
        state, m = trainer.train_step(
            state, batch(rows[j * TRAIN_BATCH:(j + 1) * TRAIN_BATCH]), gen)
        losses.append(float(m["loss"]))
    sync()
    n_tf = (tk.train_launches, tk.bwd_launches, tk.launches)
    print(f"{ENV_SMOOTH_STEPS} smoothing train steps (plain route): "
          f"{1e3 * (time.time() - ts) / ENV_SMOOTH_STEPS:.1f} ms a step; "
          f"teacher-forced launches {n_tf}; loss "
          + " ".join(f"{x:.4f}" for x in losses))
    assert all(np.isfinite(losses)) and n_tf == (0, 0, 0), (losses, n_tf)
    del state, trainer

    # ---- (7) the command lines with the flags: serve and synthesize with
    # f32 decode weights and smoothing, train with f32 train weights
    with tempfile.TemporaryDirectory() as tmp:
        tl = os.path.join(tmp, "texts.txt")
        with open(tl, "w", encoding="utf-8") as f:
            f.write(f"{texts[0]}\n{long_texts[0]}\n")
        ref_path = os.path.join(tmp, "ref.npy")
        np.save(ref_path, refs[0])
        hp = ("tacotron.compute_dtype=bfloat16,audio.trim_silence=false,"
              "tacotron.fused_decoder_dtype=float32,"
              "tacotron.fused_train_dtype=float32,tacotron.smoothing=true")
        ckpt = os.path.join(R5, "taco_ckpt.msgpack")
        dk.rows_launches = 0
        map_path = cli.main([
            "--hparams", hp, "synthesize", "--model", "Tacotron", "--mode",
            "eval", "--checkpoint", ckpt, "--ref-mel-emt", ref_path,
            "--text-list", tl, "--output-dir", os.path.join(tmp, "syn")])
        rows_cli = open(map_path, encoding="utf-8").read().splitlines()
        n_syn = dk.rows_launches
        dk.rows_launches = 0
        with open(os.path.join(tmp, "short.txt"), "w") as f:
            f.write(texts[1] + "\n")
        cli.main(["--hparams", hp, "serve", "--checkpoint", ckpt,
                  "--vocoder", "griffin_lim", "--text-list",
                  os.path.join(tmp, "short.txt"), "--output-dir",
                  os.path.join(tmp, "srv"), "--serve-batch", "1", "--steps",
                  str(MAX_STEPS)])
        served = glob.glob(os.path.join(tmp, "srv", "serve", "*.wav"))
        n_srv = dk.rows_launches
        os.symlink(os.path.join(R5, "corpus"), os.path.join(tmp, "corpus"))
        train_txt = os.path.join(tmp, "train.txt")
        hop = a.effective_hop
        with open(train_txt, "w", encoding="utf-8") as f:
            for i, t in enumerate(ctexts[:N_TRAIN]):
                n = len(t) * int(0.06 * a.sample_rate) // hop + 1
                f.write(f"corpus|audio-{i}.npy|mel-{i}.npy|l|e|{n * hop}|"
                        f"{n}|{t}|0|{i % 2}|utt{i}.wav|F\n")
        tk.train_launches = 0
        hp_t = ("tacotron.compute_dtype=bfloat16,audio.trim_silence=false,"
                "tacotron.fused_train_dtype=float32")
        ckpt_dir = cli.main(["--hparams", hp_t, "train", "--model",
                             "Tacotron", "--input-path", train_txt,
                             "--base-dir", tmp, "--train-steps", "2",
                             "--batch-size", str(TRAIN_BATCH),
                             "--eval-interval", "0"])
        saved = sorted(os.listdir(ckpt_dir))
        print(f"cli with {hp}: synthesize --mode eval {len(rows_cli)} rows "
              f"({n_syn} decode launches), serve {len(served)} wav "
              f"({n_srv} launches); cli train with fused_train_dtype=float32"
              f": {saved}, {tk.train_launches} train-forward launches")
        assert len(rows_cli) == 2 and n_syn > 0
        assert len(served) == 1 and n_srv > 0
        assert saved == ["ckpt-2.msgpack"] and tk.train_launches == 2
    done(20, t0)
    return entries


# phase 21: the WaveNet stack kernels' envelope. f32 weights (the model's
# default compute dtype, the JAX model's f32 route) with bf16 or f32 saved
# activations: nothing rounded but those, the products 3xTF32 in another
# sum order, so the skip sum is held within WN_F32_FWD of max(1, its
# largest value) and each gradient within WN_F32_BWD of its own largest
# value (on the kernel's saved activations), with phase 19's bf16 kernel on
# the same inputs as a control that must fail the same gate; bf16 weights
# at other widths are held to phase 19's gates on the largest differences
# and the cosine. Its mean gate (WN_MEAN_SHARE of the bf16-vs-f32
# distance) is printed there, not applied: on these random weights at
# depth 20 the default widths' kernel, bit for bit the one phase 19 holds
# to it on the r5 weights (share 0.46), reads ~0.55 (the "r5" set, printed
# beside the others): a moved rounding carries through the residual path
# about as far as bf16 moves the output. The f32 gate holds the kernels'
# arithmetic at each width. Widths: R, G, S, cin, layers, stacks, at B
# WN_ENV_B crops of WN_ENV_T samples.
WN_F32_FWD, WN_F32_BWD = 1e-5, 1e-4
WN_ENV_WIDTHS = {"r5": (128, 256, 128, 80, 20, 2),
                 "jax-tests": (8, 16, 8, 10, 4, 2),
                 "uneven": (24, 40, 16, 12, 3, 1),
                 "wide": (256, 512, 256, 80, 20, 2)}
WN_ENV_B, WN_ENV_T = 4, 2000
WN_ENV_STEPS = 8


def stack_outputs(k_s, k_b):
    import torch
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    out = {"skip": k_s}
    out.update(zip(list(wtk.StackParams._fields) + ["dx0", "dc"],
                   [*k_b[0], k_b[1], k_b[2]]))
    return {k: v.float() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def f32_stack_gate(name, got, want, control=None):
    """The f32 gate on {"skip": .., gradient name: ..} against `want`;
    prints the readings, raises if `got` fails it or `control` (optional)
    passes it. Returns the largest absolute difference."""
    def check(x):
        rows, bad, worst = [], [], 0.0
        for n, y in want.items():
            err = float((x[n] - y).abs().max())
            worst = max(worst, err)
            lim = (WN_F32_FWD * max(1.0, float(y.abs().max())) if n == "skip"
                   else WN_F32_BWD * float(y.abs().max()))
            rows.append(f"{n} {err:.2e} (limit {lim:.2g})")
            if not err <= lim:  # NaN fails
                bad.append(n)
        return rows, bad, worst

    rows, bad, worst = check(got)
    print(f"{name}: " + ", ".join(rows))
    assert not bad, (name, bad)
    if control is not None:
        c_rows, c_bad, _ = check(control)
        print(f"{name}, control (the bf16 kernel on the same inputs): "
              + ", ".join(c_rows) + f"; fails on {c_bad}")
        assert c_bad, f"{name}: the gate does not tell the control apart"
    return worst


def bf16_stack_gate(name, got, want, f32_skip):
    """Phase 19's gates on {"skip": .., gradient name: ..}: the skip sum
    within WN_FWD_RTOL of its largest value, each gradient within
    WN_BWD_RTOL of its largest value, the cosine of all of them >=
    WN_COSINE; the skip sum's mean difference printed beside the plain
    f32-weight stack's (phase 19's mean share, not applied here). Returns
    the largest absolute difference."""
    import torch
    errs = {n: float((got[n] - y).abs().max()) / float(y.abs().max())
            for n, y in want.items()}
    mean_k = float((got["skip"] - want["skip"]).abs().mean())
    mean_f = float((f32_skip - want["skip"]).abs().mean())
    grads = [n for n in want if n != "skip"]
    cos = float(torch.nn.functional.cosine_similarity(
        torch.cat([got[n].flatten() for n in grads]),
        torch.cat([want[n].flatten() for n in grads]), dim=0))
    print(f"{name}: max|d| / max|plain| " + ", ".join(
        f"{n} {v:.2e}" for n, v in errs.items()) + f"; skip mean {mean_k:.3e}"
          f" (plain bf16 vs f32 weights {mean_f:.3e}, share "
          f"{mean_k / mean_f:.4f}); cosine {cos:.7f}")
    assert errs["skip"] <= WN_FWD_RTOL, errs
    assert max(errs[n] for n in grads) <= WN_BWD_RTOL, errs
    assert cos >= WN_COSINE, cos
    return max(float((got[n] - y).abs().max()) for n, y in want.items())


def stack_envelope_phase(wparams, seed):
    """Phase 21: kernels 5a and 5b in f32 weights with bf16 and f32 saved
    activations at the r5 shapes, at four width sets in both weight
    types, f32 training through the kernels and the command line at the
    default dtype. Returns the `kernels` entries of kernels 5a and 5b in
    f32 (bf16 and f32 saved activations)."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli, convert
    from tacotron2_tpu_torch.config import Config, get_config
    from tacotron2_tpu_torch.models.wavenet.model import compute_wavenet_loss
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.train.tacotron_step import StepTimer
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    cfg_bf = r5_config()
    cfg = cfg_bf.replace(wavenet=dataclasses.replace(
        cfg_bf.wavenet, compute_dtype="float32"))
    B, F = len(WN_ROWS), WN_CROP_FRAMES
    t0 = phase(21, f"(n) the WaveNet stack kernels' envelope: f32 weights "
               f"with bf16 and f32 saved activations at B={B} crops of "
               f"{F * 200} samples, four width sets, f32 training")
    corpus = os.path.join(R5, "corpus")
    pairs = r5_wavenet_rows(corpus, WN_ROWS)
    rng = np.random.default_rng(seed)

    def crops():
        return wavenet_batch(pairs, [int(rng.integers(0, len(m) - F + 1))
                                     for _, m in pairs])

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    first = crops()
    common = {"route": "cuda", "library_ms": None,
              "source": "tacotron2_tpu_torch/csrc/wavenet_train.cu"}

    # ---- (1), (2) the r5 EMA weights in f32 on the first batch's stack
    # input; dskip the loss's own gradient at the kernel's skip sum
    model = convert.wavenet_from_flax(cfg, wparams, dev, trainable=True)
    b = WaveNetTrainer(cfg).batch_to_device(first)
    with torch.no_grad():
        c_up = model.upsample(b["c"])
        x0 = model.input_convolution(b["x"].float(), lambda t: t)
    T = x0.shape[1]
    N = T * B
    x2 = x0.transpose(0, 1).reshape(N, -1).contiguous()
    c2 = c_up.float().transpose(0, 1).reshape(N, -1).contiguous()
    sp = wtk.StackParams(*(t.detach() for t in wtk.extract_stack_params(
        model.residual_blocks, cfg)))
    plan_bf = wtk.make_plan(cfg_bf, B)
    readings = {}
    for acts in ("bfloat16", "float32"):
        plan = wtk.make_plan(cfg, B, acts)
        k_s, k_a = wtk.stack_fwd_cuda(plan, sp, x2, c2, seed)
        p_s, _ = wtk.stack_fwd_plain(plan, sp, x2, c2, seed)
        skip = k_s.reshape(T, B, -1).transpose(0, 1).detach() \
            .requires_grad_()
        y = model.final_convolution_2(torch.relu(model.final_convolution_1(
            torch.relu(skip))))
        loss = compute_wavenet_loss(y, b["y"], b["input_lengths"],
                                    cfg)["loss"]
        dskip = torch.autograd.grad(loss, skip)[0].transpose(0, 1).reshape(
            N, -1).contiguous()
        k_b = wtk.stack_bwd_cuda(plan, sp, k_a, c2, dskip, seed)
        p_b = wtk.stack_bwd_plain(plan, sp, k_a, c2, dskip, seed)
        c_s, c_a = wtk.stack_fwd_cuda(plan_bf, sp, x2, c2, seed)
        c_b = wtk.stack_bwd_cuda(plan_bf, sp, c_a, c2, dskip, seed)
        sync()
        err = f32_stack_gate(
            f"kernels 5a/5b, f32 weights, {acts} saved activations, vs "
            f"plain at N={N}", stack_outputs(k_s, k_b),
            stack_outputs(p_s, p_b), control=stack_outputs(c_s, c_b))
        del c_s, c_a, c_b, p_b
        k_s2, _ = wtk.stack_fwd_cuda(plan, sp, x2, c2, seed)
        k_b2 = wtk.stack_bwd_cuda(plan, sp, k_a, c2, dskip, seed)
        sync()
        exact = torch.equal(k_s, k_s2) and all(torch.equal(x, y_) for x, y_
                                               in zip([*k_b[0], k_b[1],
                                                       k_b[2]],
                                                      [*k_b2[0], k_b2[1],
                                                       k_b2[2]]))
        print(f"{acts} saved activations: reruns bit-exact: {exact}")
        assert exact
        del k_s2, k_b2, k_b
        fwd_ms = cuda_ms(lambda: wtk.stack_fwd_cuda(plan, sp, x2, c2, seed),
                         3)
        fwd_plain = cuda_ms(lambda: wtk.stack_fwd_plain(plan, sp, x2, c2,
                                                        seed), 1)
        bwd_ms = cuda_ms(lambda: wtk.stack_bwd_cuda(plan, sp, k_a, c2, dskip,
                                                    seed), 3)
        bwd_plain = cuda_ms(lambda: wtk.stack_bwd_plain(plan, sp, k_a, c2,
                                                        dskip, seed), 1)
        fb = stack_bound_s(plan, N, backward=False)
        bb = stack_bound_s(plan, N, backward=True)
        print(f"f32 weights, {acts} saved activations, at B={B}, T={T} "
              f"(N={N}): kernel 5a {fwd_ms:.3f} ms (plain {fwd_plain:.3f}, "
              f"bound {1e3 * fb[0]:.4f} ms, {fb[1]}); kernel 5b "
              f"{bwd_ms:.3f} ms (plain {bwd_plain:.3f}, bound "
              f"{1e3 * bb[0]:.4f} ms, {bb[1]})")
        readings[acts] = dict(err=err, fwd=(fwd_ms, fwd_plain, fb),
                              bwd=(bwd_ms, bwd_plain, bb))
        del k_s, k_a, p_s, dskip
        torch.cuda.empty_cache()
    del model

    # ---- (3) widths, both weight types, random init_wavenet weights
    for wname, (R, G, S, Ci, layers, stacks) in WN_ENV_WIDTHS.items():
        wcfg = Config()
        wcfg = wcfg.replace(wavenet=dataclasses.replace(
            wcfg.wavenet, layers=layers, stacks=stacks, residual_channels=R,
            gate_channels=G, skip_out_channels=S, cin_channels=Ci))
        m = convert.init_wavenet(wcfg, torch.Generator().manual_seed(seed),
                                 dev)
        wsp = wtk.StackParams(*(t.detach() for t in
                                wtk.extract_stack_params(
                                    m.residual_blocks, wcfg)))
        g = torch.Generator(dev).manual_seed(seed)
        Nw = WN_ENV_B * WN_ENV_T
        xw = torch.randn(Nw, R, generator=g, device=dev) * 0.5
        cw = torch.rand(Nw, Ci, generator=g, device=dev)
        dw = torch.randn(Nw, S, generator=g, device=dev) * 1e-2
        for wd in ("float32", "bfloat16"):
            plan = wtk.make_plan(wcfg.replace(wavenet=dataclasses.replace(
                wcfg.wavenet, compute_dtype=wd)), WN_ENV_B)
            k_s, k_a = wtk.stack_fwd_cuda(plan, wsp, xw, cw, seed)
            p_s, _ = wtk.stack_fwd_plain(plan, wsp, xw, cw, seed)
            k_b = wtk.stack_bwd_cuda(plan, wsp, k_a, cw, dw, seed)
            p_b = wtk.stack_bwd_plain(plan, wsp, k_a, cw, dw, seed)
            sync()
            name = (f"{wname} widths R {R} G {G} S {S} cin {Ci}, {layers} "
                    f"layers, {wd} weights, N={Nw}")
            if wd == "float32":
                f32_stack_gate(name, stack_outputs(k_s, k_b),
                               stack_outputs(p_s, p_b))
            else:
                f_s, _ = wtk.stack_fwd_plain(dataclasses.replace(
                    plan, weight_bf16=False), wsp, xw, cw, seed)
                bf16_stack_gate(name, stack_outputs(k_s, k_b),
                                stack_outputs(p_s, p_b), f_s)
        del m, wsp

    # ---- (4) f32 training from init_wavenet: the main path's counts
    trainer = WaveNetTrainer(cfg)
    state = trainer.init_state(torch.Generator().manual_seed(seed), first)
    gen = torch.Generator().manual_seed(seed + 1)
    batches = [crops() for _ in range(WN_ENV_STEPS)]
    losses, split = [], {}
    wtk.fwd_launches = wtk.bwd_launches = 0
    sync()
    for i, batch in enumerate(batches):
        timed = i >= WN_ENV_STEPS // 2
        trainer.timer = StepTimer() if timed else None
        sync()
        t_step = time.time()
        state, m_ = trainer.train_step(state, batch, gen)
        losses.append(float(m_["loss"]))
        if timed:
            k = WN_ENV_STEPS - WN_ENV_STEPS // 2
            for n, v in trainer.timer.totals().items():
                split[n] = split.get(n, 0.0) + v / k
            split["step (host clock)"] = split.get(
                "step (host clock)", 0.0) + 1e3 * (time.time() - t_step) / k
    sync()
    launches = (wtk.fwd_launches, wtk.bwd_launches)
    trainer.timer = None
    print(f"{WN_ENV_STEPS} f32 train steps from init_wavenet: kernel "
          f"launches 5a {launches[0]}, 5b {launches[1]}; loss "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"f32 ms per step (mean of steps {WN_ENV_STEPS // 2 + 1}-"
          f"{WN_ENV_STEPS}): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in split.items()))
    assert launches == (WN_ENV_STEPS, WN_ENV_STEPS), launches
    ref = WaveNetTrainer(cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, use_fused_train_stack=False)))
    ref_state = ref.init_state(torch.Generator().manual_seed(seed), first)
    ref_gen = torch.Generator().manual_seed(seed + 1)
    ref_losses = [float(ref.train_step(ref_state, b_, ref_gen)[1]["loss"])
                  for b_ in batches]
    traj = max(abs(x - y_) for x, y_ in zip(losses, ref_losses))
    print(f"the {WN_ENV_STEPS} losses against the f32 layer loop's: max "
          f"|difference| {traj:.3e}")
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert traj <= WN_TRAJ_ATOL, (losses, ref_losses)
    del state, ref_state, trainer, ref
    # f32 saved activations through the user-facing function: autograd
    # of fused_stack_apply(acts_dtype_name="float32"), twice
    model = convert.wavenet_from_flax(cfg, wparams, dev, trainable=True)
    wtk.fwd_launches = wtk.bwd_launches = 0
    for _ in range(2):
        xa = x0.detach().requires_grad_()
        sk = wtk.fused_stack_apply(
            cfg, wtk.extract_stack_params(model.residual_blocks, cfg), xa,
            c_up, seed, acts_dtype_name="float32")
        sk.square().mean().backward()
    sync()
    launches32 = (wtk.fwd_launches, wtk.bwd_launches)
    print(f"fused_stack_apply with f32 saved activations, forward and "
          f"backward twice: launches 5a {launches32[0]}, 5b "
          f"{launches32[1]}; finite gradients "
          f"{bool(torch.isfinite(xa.grad).all())}")
    assert launches32 == (2, 2) and torch.isfinite(xa.grad).all()
    del model, xa, sk
    # the paper preset's stack (legacy=False, residual_legacy=False, f32)
    # on random weights and inputs: one train step through the kernels
    pcfg = get_config("paper", "wavenet.use_fused_train_stack=true")
    hop = pcfg.audio.effective_hop
    prng = np.random.default_rng(seed)
    xp = prng.uniform(-0.5, 0.5, (2, 10 * hop, 1)).astype(np.float32)
    pbatch = dict(x=xp, y=xp[..., 0].copy(), c=prng.uniform(
        0, 1, (2, 10, pcfg.audio.num_mels)).astype(np.float32),
        input_lengths=np.full(2, 10 * hop, np.int32))
    ptr = WaveNetTrainer(pcfg)
    pst = ptr.init_state(torch.Generator().manual_seed(seed), pbatch)
    wtk.fwd_launches = wtk.bwd_launches = 0
    pst, pm = ptr.train_step(pst, pbatch, torch.Generator().manual_seed(1))
    sync()
    print(f"paper preset train step: launches 5a {wtk.fwd_launches}, 5b "
          f"{wtk.bwd_launches}; loss {float(pm['loss']):.4f}")
    assert (wtk.fwd_launches, wtk.bwd_launches) == (1, 1)
    assert np.isfinite(float(pm["loss"]))
    del ptr, pst

    # ---- (5) the command line at the default dtype: train --model
    # WaveNet (3 steps), its checkpoint through synthesize --model WaveNet
    hp = ("wavenet.use_fused_train_stack=true,audio.trim_silence=false,"
          f"train.max_time_steps={F * 200}")
    assert Config().wavenet.compute_dtype == "float32"
    with tempfile.TemporaryDirectory() as tmp:
        map_txt = os.path.join(tmp, "map.txt")
        with open(map_txt, "w", encoding="utf-8") as f:
            for i in WN_ROWS:
                a = os.path.join(corpus, "audio", f"audio-{i}.npy")
                m = os.path.join(corpus, "mels", f"mel-{i}.npy")
                f.write(f"{a}|{m}|{m}|0|text\n")
        wtk.fwd_launches = wtk.bwd_launches = 0
        ckpt_dir = cli.main(["--hparams", hp, "train", "--model", "WaveNet",
                             "--input-path", map_txt, "--base-dir", tmp,
                             "--train-steps", "3", "--batch-size", str(B),
                             "--eval-interval", "0"])
        saved = sorted(os.listdir(ckpt_dir))
        n_cli = (wtk.fwd_launches, wtk.bwd_launches)
        mel = os.path.join(tmp, "mel-8.npy")
        np.save(mel, pairs[0][1][:8])
        one = os.path.join(tmp, "one.txt")
        with open(one, "w", encoding="utf-8") as f:
            f.write(f"a.npy|{mel}|{mel}|0|text\n")
        out = cli.main(["--hparams", hp, "synthesize", "--model", "WaveNet",
                        "--wavenet-checkpoint",
                        os.path.join(ckpt_dir, saved[0]), "--mels-map", one,
                        "--output-dir", os.path.join(tmp, "out")])
        with wave.open(out[0]) as w:
            n_wav = w.getnframes()
        print(f"cli train --model WaveNet at the default dtype (f32), 3 "
              f"steps: checkpoints {saved}, launches 5a {n_cli[0]}, 5b "
              f"{n_cli[1]}; synthesize --model WaveNet on it: {n_wav} "
              f"samples for 8 frames")
        assert saved == ["ckpt-3.msgpack"] and n_cli == (3, 3)
        assert n_wav == 8 * 200
    done(21, t0)
    entries = []
    for acts, suffix, n in (("bfloat16", "_f32", launches),
                            ("float32", "_f32_acts", launches32)):
        r = readings[acts]
        for i, (name, line) in enumerate((("fwd", 133), ("bwd", 261))):
            ms, plain_ms, (bound_s, bound_by) = r[name]
            entries.append(dict(
                common, name=f"wavenet_stack_{name}{suffix}",
                replaces=f"tacotron2_tpu/ops/wavenet_train_kernel.py:{line}",
                launches=n[i], max_abs_err=r["err"], ms=ms,
                plain_ms=plain_ms, bound_ms=1e3 * bound_s,
                bound_by=bound_by))
    return entries


# phase 22: the redesigned kernels' other routes and shapes (Griffin-Lim's
# DFT route at a non-power-of-two n_fft; the sampler at B=1, 16 and 32), and
# the Griffin-Lim launches by route on the main paths
GL_DFT_NFFT = 1000


def routes_phase(cfg, prog, batch, gl_routes, y_k8, y_kb8, W):
    """Returns the `kernels` entry of the Griffin-Lim DFT route."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.data import audio as host_audio
    from tacotron2_tpu_torch.ops import griffin_lim as gl
    from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
    from tacotron2_tpu_torch.ops import stft as tst
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    t0 = phase(22, f"(o) Griffin-Lim's DFT route (n_fft {GL_DFT_NFFT}), the "
                   f"sampler at B=1, 16 and 32, launches by route")
    # ---- (1) the DFT route against its plain version, as phase 10 holds
    # the FFT route, on the eval mels re-analysed for n_fft 1,000
    cfg_d = cfg.with_overrides(f"audio.n_fft={GL_DFT_NFFT}")
    a = cfg_d.audio
    n_fft, hop, win, iters = a.n_fft, a.effective_hop, a.win_size, \
        a.griffin_lim_iters
    assert glk.route(n_fft) == "dft" and glk.route(cfg.audio.n_fft) == "fft"
    S = gl_magnitudes(batch, a, "cuda")
    zeros = torch.zeros_like(S)
    glk.launches = glk.launches_fft = glk.launches_dft = 0
    y_k0 = glk.fused_griffin_lim(S, S, zeros, n_fft, hop, win, 0)
    y_k4 = glk.fused_griffin_lim(S, S, zeros, n_fft, hop, win, 4)
    y_k = glk.fused_griffin_lim(S, S, zeros, n_fft, hop, win, iters)
    assert (glk.launches_fft, glk.launches_dft) == (0, 3), \
        (glk.launches_fft, glk.launches_dft)
    y_p0 = glk.griffin_lim_plain(S, S, zeros, n_fft, hop, win, 0)
    y_p4 = glk.griffin_lim_plain(S, S, zeros, n_fft, hop, win, 4)
    y_p = glk.griffin_lim_plain(S, S, zeros, n_fft, hop, win, iters)
    y_d4 = library_griffin_lim(S.double(), n_fft, hop, win, 4)
    torch.cuda.synchronize()
    err0 = float((y_k0 - y_p0).abs().max())
    err4 = float((y_k4 - y_p4).abs().max())
    rms = lambda d: float(d.double().pow(2).mean().sqrt())
    rms_k4, rms_p4 = rms(y_k4 - y_d4), rms(y_p4 - y_d4)
    cons = lambda y: float((tst.stft_mag(y.contiguous(), n_fft, hop, win)
                            - S).abs().mean())
    c_k, c_p = cons(y_k), cons(y_p)
    print(f"DFT route [B={S.shape[0]}, F={S.shape[1]}, K={S.shape[2]}]: iters "
          f"0 max |kernel - plain| {err0:.3e}; iters 4 {err4:.3e}, rms from "
          f"float64 kernel {rms_k4:.3e} plain {rms_p4:.3e}; {iters} iterations "
          f"consistency kernel {c_k:.6f} plain {c_p:.6f}")
    assert err0 <= 1e-4, err0
    assert err4 <= GL_ITERS4_ATOL, err4
    assert rms_k4 <= GL_ITERS4_F64_RATIO * rms_p4, (rms_k4, rms_p4)
    assert c_k <= 1.01 * c_p, (c_k, c_p)
    # the user-facing path at this n_fft: a 440 Hz tone through
    # inv_mel_spectrogram, counted by route
    sr = a.sample_rate
    tone = (0.2 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)).astype(
        np.float32)
    mel_tone = host_audio.mel_spectrogram(
        host_audio.preemphasis(tone, a.preemphasis, a.preemphasize), a)
    glk.launches = glk.launches_fft = glk.launches_dft = 0
    y_tone = host_audio.inv_preemphasis(gl.inv_mel_spectrogram(
        torch.as_tensor(mel_tone, device="cuda"), a).cpu().numpy(),
        a.preemphasis, a.preemphasize)
    dft_launches = glk.launches_dft
    spec = np.abs(np.fft.rfft(y_tone))
    peak = float(np.fft.rfftfreq(len(y_tone), 1.0 / sr)[spec.argmax()])
    print(f"440 Hz tone through inv_mel_spectrogram at n_fft {n_fft}: peak "
          f"{peak:.2f} Hz; launches by route fft {glk.launches_fft} dft "
          f"{dft_launches}")
    assert abs(peak - 440.0) < 5.0, peak
    assert glk.launches_fft == 0 and dft_launches > 0
    ms = cuda_ms(lambda: glk.fused_griffin_lim(S, S, zeros, n_fft, hop, win,
                                               iters), 3)
    plain_ms = cuda_ms(lambda: glk.griffin_lim_plain(S, S, zeros, n_fft, hop,
                                                     win, iters), 1)
    lib_ms = cuda_ms(lambda: library_griffin_lim(S, n_fft, hop, win, iters),
                     3)
    Bg, Fg, Kg = S.shape
    ops_s = griffin_lim_flops(Bg, Fg, n_fft, win, iters) / F32_FLOPS
    bytes_s = (3 * Bg * Fg * Kg + Bg * hop * (Fg - 1)) * 4 / HBM_BYTES_PER_S
    print(f"DFT route timed: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"torch.stft/istft {lib_ms:.3f} ms, bound "
          f"{1e3 * max(ops_s, bytes_s):.4f} ms")
    entry = {"name": "griffin_lim_dft", "route": "cuda", "gl_route": "dft",
             "source": "tacotron2_tpu_torch/csrc/griffin_lim.cu",
             "replaces": "tacotron2_tpu/ops/griffin_lim_kernel.py:108",
             "launches": dft_launches, "max_abs_err": err0, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": 1e3 * max(ops_s, bytes_s),
             "bound_by": "operations" if ops_s >= bytes_s else "bytes",
             "library_ms": lib_ms}
    # ---- (2) the sampler at B=1, 16 and 32 (1, 2 and 4 clusters) on
    # distinct rows: cluster k runs the serve call's 8 rows over samples
    # kW .. (k+1)W (their own conditioning and noise), against the plain
    # version; every row is the B=8 run's on the same window bit for bit
    # (a row's arithmetic does not see the others; window 0's B=8 runs are
    # phase 5's)
    im = prog.intermediates
    sp = prog.sampler_params
    assert im["c_up"].shape[1] >= 4 * W, im["c_up"].shape
    windows = [(im["c_up"][:, k * W:(k + 1) * W].contiguous(),
                im["noise"][:, :, k * W:(k + 1) * W].contiguous())
               for k in range(4)]
    bf16 = dict(cache_dtype=torch.bfloat16, weight_dtype=torch.bfloat16)
    kw32 = wk.pack_weights(sp, cfg)
    ref32, refb = [y_k8], [y_kb8]
    for c_k, n_k in windows[1:]:
        ref32.append(wk.sample(sp, cfg, c_k, n_k,
                               kernel_weights=kw32).cpu().numpy())
        refb.append(wk.sample(sp, cfg, c_k, n_k,
                              kernel_weights=prog.sampler_kernel)
                    .cpu().numpy())
    for B in (1, 16, 32):
        k = max(1, B // 8)
        c_b = torch.cat([c for c, _ in windows[:k]])[:B].contiguous()
        n_b = torch.cat([n for _, n in windows[:k]], 1)[:, :B].contiguous()
        wk.launches = 0
        y32 = wk.sample(sp, cfg, c_b, n_b, kernel_weights=kw32)
        yb = wk.sample(sp, cfg, c_b, n_b, kernel_weights=prog.sampler_kernel)
        assert wk.launches == 2, wk.launches
        p32 = wk.sample_plain(sp, cfg, c_b, n_b)
        r16, _ = wk.teacher_forced_replay(sp, cfg, c_b, n_b, yb, **bf16)
        r32, _ = wk.teacher_forced_replay(sp, cfg, c_b, n_b, yb)
        torch.cuda.synchronize()
        y32, yb, p32, r16, r32 = (x.cpu().numpy() for x in (y32, yb, p32,
                                                            r16, r32))
        err = float(np.abs(y32 - p32).max())
        bf_err = float(np.abs(yb - r16).max())
        bf_err32 = float(np.abs(yb - r32).max())
        rows = np.concatenate(ref32[:k])[:B]
        rows_b = np.concatenate(refb[:k])[:B]
        same = bool(np.array_equal(y32, rows) and np.array_equal(yb, rows_b))
        distinct = B == 1 or not np.array_equal(y32[:8], y32[8:16])
        print(f"sampler B={B} ({k} cluster(s), distinct rows {distinct}): "
              f"f32 max |kernel - plain| {err:.3e}; bf16 max |kernel - "
              f"replay| {bf_err:.3e} (against the f32 replay "
              f"{bf_err32:.3e}); every row the B=8 run's on its window bit "
              f"for bit: {same}")
        assert err <= SAMPLER_F32_ATOL, err
        assert bf_err <= SAMPLER_REPLAY_ATOL["bfloat16"], bf_err
        assert bf_err <= 0.5 * bf_err32, (bf_err, bf_err32)
        assert same and distinct, B
    # ---- (3) launches by route on the main paths
    print(f"Griffin-Lim launches by route (fft, dft): {gl_routes}")
    assert all(f > 0 and d == 0 for f, d in gl_routes.values()), gl_routes
    done(22, t0)
    return entry


# phase 23: the decode at other batch sizes, on the serve call's rows
ROWS_SETS = {1: [3], 9: list(range(8)) + [5],
             16: list(range(8)) + list(range(7, -1, -1))}
ROWS_STEPS = 32
# phase 23: WaveNet synthesis at a width the sampler kernel refuses (its
# 16-wide tiles), frames of each of two ground-truth mels
R_PLAIN, R_PLAIN_FRAMES = 120, 4


def rows_phase(cfg, prog, gt, seed):
    """Phase 23: kernel 1 (csrc/decoder_rows.cu) at B=1, 9 and 16 (1, 2
    and 2 clusters of 8 rows; B=9's second cluster holds one row) on rows
    of the serve call, each held against the plain version by
    `replay_gate` over its first ROWS_STEPS steps and, row for row, bit for
    bit the B=8 run's; then `WaveNetSynthesizer` at R=R_PLAIN on the card:
    the sampler kernel refuses the width, so it samples through the plain
    version, to finished, finite wavs, with no kernel launch."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.models.tacotron.decoder import WHOLE
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.synth.wavenet_synth import WaveNetSynthesizer
    t0 = phase(23, "(p) the serve decode at B=1, 9 and 16; WaveNet "
                   f"synthesis at R={R_PLAIN} on the card")
    im = prog.intermediates
    T, M = im["memory"].shape[1:]
    dp, kw = prog.dec_params, prog.dec_kernel
    dp_u = f32_activations(dp)

    def operands(ix):
        ix_t = torch.as_tensor(ix, device="cuda")
        args = (cfg, *(im[k][ix_t].contiguous()
                       for k in ("keys", "memory", "mask")))
        drop = im["drop"][ix_t, :ROWS_STEPS].contiguous()
        return args, dk.init_decoder_state(cfg, len(ix), T, M, "cuda"), drop

    args8, st8, drop8 = operands(list(range(8)))
    f8 = dk.decode_block(dp, *args8, st8, drop8, casts=WHOLE,
                         kernel_weights=kw)[0]
    plan = dk.rows_plan(dk.rows_widths(cfg, M, T), kw.rows.cs, False)
    print(f"decode plan at T_in={T}: {kw.rows.cs} CTAs a cluster, {plan}")
    for Bn, ix in ROWS_SETS.items():
        args, st, drop = operands(ix)
        dk.rows_launches = dk.launches = 0
        full = dk.decode_block(dp, *args, st, drop, casts=WHOLE,
                               kernel_weights=kw)
        n_launch = dk.rows_launches
        err = replay_gate(
            f"decoder at B={Bn} over the first {ROWS_STEPS} steps",
            lambda s_, d: dk.decode_block(dp, *args, s_, d, casts=WHOLE,
                                          kernel_weights=kw),
            lambda s_, d: dk.decode_block_plain(dp, *args, s_, d,
                                                casts=WHOLE),
            lambda s_, d: dk.decode_block_plain(dp_u, *args, s_, d),
            st, drop, full)
        same = [bool(torch.equal(full[0][i], f8[j]))
                for i, j in enumerate(ix)]
        print(f"B={Bn}: {-(-Bn // 8)} clusters, launches {n_launch}, max "
              f"|kernel - plain| {err:.3e}; rows bit for bit the B=8 "
              f"run's: {sum(same)} of {Bn}")
        assert n_launch == 1 and dk.launches == 0 and all(same)

    cfg_w = cfg.with_overrides(f"wavenet.residual_channels={R_PLAIN}")
    assert wk.sampler_supported(cfg) and not any(
        wk.sampler_supported(cfg_w, dt)
        for dt in (torch.float32, torch.bfloat16))
    ws = WaveNetSynthesizer(cfg_w, random_wavenet_tree(cfg_w, seed),
                            device="cuda", seed=seed)
    assert ws.sampler_kernel is None
    wk.launches = 0
    ts = time.time()
    wavs = ws.synthesize([g[:R_PLAIN_FRAMES] for g in gt[:2]])
    n = R_PLAIN_FRAMES * cfg_w.audio.effective_hop
    print(f"WaveNetSynthesizer at R={R_PLAIN}: route plain, sampler kernel "
          f"launches {wk.launches}, wavs {[len(w) for w in wavs]} samples, "
          f"finite {all(np.isfinite(w).all() for w in wavs)}, "
          f"{time.time() - ts:.3f} s")
    assert wk.launches == 0 and all(len(w) == n and np.isfinite(w).all()
                                    for w in wavs)
    done(23, t0)


# phase 24: kernel 4a (csrc/decoder_rows.cu's teacher-forced mode) at
# other batch sizes, on rows 0..B-1 of the first 32 r5 train texts at phase
# 16's shapes: 1, 2, 2 and 4 clusters of 8 rows (B=9's second cluster
# holds one row); B=32 runs first, its rows the reference of the others'
TF_ROWS_BATCHES = (32, 16, 9, 1)


def train_rows_phase(tparams, stats, seed):
    """Phase 24: kernel 4a in train and eval mode at B=32, 16, 9 and 1 on
    the r5 weights (bf16) with mixed coins (ratio 0.5), phase 16's dropout
    and zoneout draws: the train mode held against its plain version as
    phase 16 holds it (`hold_train_fwd`), the eval mode by phase 15's
    shares (TF_WITHIN) and a mean frame difference at most 0.1x that of
    the plain version with f32 activations; each mode's rerun bit for bit,
    and every row bit for bit the B=32 launch's."""
    import torch
    from tacotron2_tpu_torch.convert import load_tacotron
    from tacotron2_tpu_torch.eval.convergence import batch_from_rows
    from tacotron2_tpu_torch.models.tacotron.decoder import (
        drop_masks, teacher_inputs, zoneout_masks)
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    cfg = train_config()
    r = cfg.tacotron.outputs_per_step
    n_max = max(TF_ROWS_BATCHES)
    t0 = phase(24, f"(q) kernel 4a at B={TF_ROWS_BATCHES}, train and eval "
               f"mode, mixed coins")
    rows = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
            for i, t in enumerate(corpus_texts()[:n_max])]
    first = batch_from_rows(rows, os.path.join(R5, "corpus", "mels"), cfg,
                            pad_text_to=PAD_TEXT, pad_mel_to=PAD_MEL)
    dev = torch.device("cuda")
    model = load_tacotron(Tacotron(cfg), tparams, stats).to(dev)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in first.items()}
    with torch.no_grad():
        keys, memory, mask, _, _ = model.synthesis_memory_ext(
            tb["inputs"], tb["input_lengths"], tb["ref_mel_emt"],
            tb["ref_mel_spk"])
        dp = tk.cast_params(tk.extract_params_traced(model.decoder, cfg),
                            torch.bfloat16)
    del model
    kw = dk.pack_weights(dp)
    S = PAD_MEL // r
    g = torch.Generator(device=dev).manual_seed(seed)
    teacher = teacher_inputs(tb["mel_targets"], r)
    coins = (torch.rand(S, generator=g, device=dev) < 0.5).to(torch.int32)
    drop = drop_masks(cfg, n_max, S, g, dev)
    zmask = zoneout_masks(cfg, n_max, S, g, dev)
    print(f"{int(coins.sum())} of {S} coins set; {kw.rows.cs} CTAs a "
          f"cluster")
    ref = None
    for Bn in TF_ROWS_BATCHES:
        sl = slice(0, Bn)
        fargs = (dp, cfg, keys[sl], memory[sl], mask[sl],
                 teacher[:, sl].contiguous(), coins, drop[sl], zmask[sl])
        eargs = fargs[:-1]
        dk.launches = tk.launches = tk.train_launches = 0
        k_t, k_t2 = (tk.teacher_forced_train_fwd(*fargs, kernel_weights=kw)
                     for _ in range(2))
        k_e, k_e2 = (tk.teacher_forced_fwd(*eargs, kernel_weights=kw)
                     for _ in range(2))
        torch.cuda.synchronize()
        n = (tk.train_launches, tk.launches, dk.launches)
        rerun = (all(torch.equal(x, y) for x, y in zip(k_t[:3], k_t2[:3]))
                 and all(torch.equal(k_t[3][k], k_t2[3][k])
                         for k in tk.RES_NAMES)
                 and all(torch.equal(x, y) for x, y in zip(k_e, k_e2)))
        del k_t2, k_e2
        hold_train_fwd(f"kernel 4a train mode at B={Bn}", fargs, k_t)
        p_e = tk.teacher_forced_fwd_plain(*eargs)
        f_e = tk.teacher_forced_fwd_plain(f32_activations(dp), *eargs[1:])
        torch.cuda.synchronize()
        spread = {m: tf_spread(x, p_e) for m, x in (
            ("kernel", k_e), ("plain with f32 activations", f_e))}
        for m, d in spread.items():
            print(f"kernel 4a eval mode at B={Bn}, {m} vs plain: " + ", ".join(
                f"{k} {v:.3e}" for k, v in d.items()))
        errs = spread["kernel"]
        assert min(errs[k] for k in TF_WITHIN) >= 0.99, (Bn, errs)
        assert errs["frames mean"] <= 0.1 * spread[
            "plain with f32 activations"]["frames mean"], (Bn, spread)
        outs = [*k_t[:3], *k_e, *(k_t[3][k] for k in tk.RES_NAMES)]
        if ref is None:
            ref = outs
        same = [all(torch.equal(x[i], y[i]) for x, y in zip(outs, ref))
                for i in range(Bn)]
        print(f"B={Bn}: {-(-Bn // 8)} clusters; launches: train "
              f"{n[0]}, eval {n[1]} (csrc/decoder_rows.cu), csrc/decoder.cu "
              f"{n[2]}; reruns bit-identical {rerun}; rows bit for bit the "
              f"B={n_max} launch's: {sum(same)} of {Bn}")
        assert n == (2, 2, 0) and rerun and all(same), (Bn, n, rerun)
        del k_t, k_e, p_e, f_e, outs
    done(24, t0)


# phase 25: kernels 5a and 5b at B=1, 3 and 32 (N = B·1,007 rows, not a
# multiple of the 128-row tile) on the r5 EMA weights, both weight types,
# held by phase 19's bf16 gates and phase 21's f32 gates, reruns bit for
# bit; the kernel launches a layer; each launch kind's device time at
# phase 19's shapes (B 16 × 8,000 samples) under torch.profiler
WN_ROWS_BATCHES, WN_ROWS_T = (1, 3, 32), 1007
STACK_KINDS = ("fwd_pre_kernel", "fwd_layer_kernel", "bwd_gate_kernel",
               "bwd_dx_kernel", "wgrad_kernel", "reduce_kernel")
WGRAD_PRODUCTS = ("tap 0", "tap 1", "tap 2", "cin", "out|skip")


def stack_launch_split(fn, kinds=STACK_KINDS, by_product=False):
    """{kernel name: [ms, launches]} of one fn() under torch.profiler, the
    wrappers' PyTorch operations as "other". With by_product, a version
    that launches one weight-gradient kernel a product has those launches
    split by product (the k-th after each gate launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    names = [next((k for k in kinds if k in e.name), "other") for e in evs]
    split = by_product and names.count("wgrad_kernel") > names.count(
        "bwd_gate_kernel")
    out, nth = {}, 0
    for e, kind in zip(evs, names):
        if kind == "bwd_gate_kernel":
            nth = 0
        elif kind == "wgrad_kernel" and split:
            kind = f"wgrad_kernel {WGRAD_PRODUCTS[nth % 5]}"
            nth += 1
        slot = out.setdefault(kind, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    return out


def stack_rows_phase(wparams, seed):
    """Phase 25: kernels 5a and 5b at B=1, 3 and 32 against their plain
    versions, reruns bit for bit, launches a layer, the launch kinds'
    times."""
    import torch
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.models.wavenet.modules import round_bf16
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    cfg = r5_config()
    t0 = phase(25, f"(r) the WaveNet stack kernels at B={WN_ROWS_BATCHES} "
               f"(T {WN_ROWS_T}), launches a layer, each launch kind's time")
    dev = torch.device("cuda")
    model = convert.wavenet_from_flax(cfg, wparams, dev, trainable=True)
    sp = wtk.StackParams(*(t.detach() for t in wtk.extract_stack_params(
        model.residual_blocks, cfg)))
    wn = cfg.wavenet
    g = torch.Generator(dev).manual_seed(seed)

    def inputs(N):
        x2 = torch.randn(N, wn.residual_channels, generator=g,
                         device=dev) * 0.5
        c2 = round_bf16(torch.rand(N, wn.cin_channels, generator=g,
                                   device=dev))
        dskip = torch.randn(N, wn.skip_out_channels, generator=g,
                            device=dev) * 1e-3
        return x2, c2, dskip

    per_layer = []
    for B in WN_ROWS_BATCHES:
        N = B * WN_ROWS_T
        x2, c2, dskip = inputs(N)
        plan = wtk.make_plan(cfg, B)
        plan32 = dataclasses.replace(plan, weight_bf16=False)
        f_s, _ = wtk.stack_fwd_plain(plan32, sp, x2, c2, seed)
        for pl in (plan, plan32):
            n0 = (wtk.fwd_kernel_launches, wtk.bwd_kernel_launches)
            k_s, k_a = wtk.stack_fwd_cuda(pl, sp, x2, c2, seed)
            k_b = wtk.stack_bwd_cuda(pl, sp, k_a, c2, dskip, seed)
            per_layer.append(((wtk.fwd_kernel_launches - n0[0]) / pl.L,
                              (wtk.bwd_kernel_launches - n0[1]) / pl.L))
            p_s, _ = wtk.stack_fwd_plain(pl, sp, x2, c2, seed)
            p_b = wtk.stack_bwd_plain(pl, sp, k_a, c2, dskip, seed)
            k_s2, k_a2 = wtk.stack_fwd_cuda(pl, sp, x2, c2, seed)
            k_b2 = wtk.stack_bwd_cuda(pl, sp, k_a, c2, dskip, seed)
            torch.cuda.synchronize()
            got, want = stack_outputs(k_s, k_b), stack_outputs(p_s, p_b)
            name = (f"B={B} (N {N}), {'bf16' if pl.weight_bf16 else 'f32'} "
                    f"weights")
            if pl.weight_bf16:
                bf16_stack_gate(name, got, want, f_s)
            else:
                f32_stack_gate(name, got, want)
            again = stack_outputs(k_s2, k_b2)
            exact = torch.equal(k_a, k_a2) and all(
                torch.equal(got[n], again[n]) for n in got)
            print(f"{name}: reruns bit-exact {exact}")
            assert exact, name
    fwd_pl, bwd_pl = max(x for x, _ in per_layer), max(y for _, y in
                                                       per_layer)
    print(f"kernel launches a layer: forward {fwd_pl:.3f} (a pre-pass and "
          f"one a layer), backward {bwd_pl:.3f}")
    assert bwd_pl <= 4, per_layer

    B, T = len(WN_ROWS), WN_CROP_FRAMES * 200
    x2, c2, dskip = inputs(B * T)
    for wd in ("bfloat16", "float32"):
        pl = wtk.make_plan(cfg.replace(wavenet=dataclasses.replace(
            wn, compute_dtype=wd)), B)
        _, k_a = wtk.stack_fwd_cuda(pl, sp, x2, c2, seed)
        for what, fn, kinds in (
                ("5a", lambda: wtk.stack_fwd_cuda(pl, sp, x2, c2, seed),
                 STACK_KINDS[:2]),
                ("5b", lambda: wtk.stack_bwd_cuda(pl, sp, k_a, c2, dskip,
                                                  seed), STACK_KINDS[2:])):
            n0 = wtk.fwd_kernel_launches + wtk.bwd_kernel_launches
            split = stack_launch_split(fn)
            # the wrappers' counts (two passes) against the profiler's
            counted = (wtk.fwd_kernel_launches + wtk.bwd_kernel_launches
                       - n0) // 2
            seen = sum(split.get(k, (0, 0))[1] for k in kinds)
            print(f"{what} {wd} at B={B}, T={T}, launch kinds (ms, "
                  f"launches): " + ", ".join(
                      f"{k} {v[0]:.3f} ({v[1]})" for k, v in split.items())
                  + f"; kernel launches counted {counted}, profiled {seen}")
            assert counted == seen, (what, wd, counted, seen)
            assert what == "5a" or seen <= 4 * pl.L, (wd, seen, pl.L)
        del k_a
    torch.cuda.empty_cache()
    done(25, t0)


# phase 26: the fork's Tacotron training modes at phase 16's shapes (B 16,
# text padded to 96, mels to 448, bf16 compute). (b)'s tolerance, written
# before the first run: the f32 fused route and autograd through the
# plain decode compute one function, 4b's f32 products (3xTF32) against
# cuBLAS's f32 ones in another order, so each whole gradient is held to
# phase 20's BWD_RTOL (1e-4) of its largest magnitude. The first reading
# (fused against decode="autograd") missed it in 'loss' (4.4e-4) and
# 'd_loss' (5.8e-3), in nat-GAN's encoder alone, while 'loss_no_mo_up',
# whose gradient crosses both passes' 4b, read 7e-8: nat-GAN's gradients
# follow the difference of near-equal mels (targets, outputs), so the two
# forwards' last digits (4a against the plain decode) move them, and
# 'd_loss' reaches no decode backward at all. The gate therefore holds the
# fused route against decode="replay" (autograd's backward through the
# plain decode on the fused route's forward values), at the same 1e-4;
# the fused-against-autograd reading is printed beside it.
VARIANT_FLAGS = dict(use_unpaired=True, adv_emb_disc=True, nat_gan=True,
                     opt_ref_no_mo=True, pretrained_emb_disc=True)
VARIANT_STEPS, VARIANT_PRE_STEPS = 8, 8
VARIANT_GRAD_RTOL = BWD_RTOL
# kernel launches a step of the all-on trainer: 4a once a pass; 4b once a
# pass for 'loss' and again for 'loss_no_mo_up' (both reach the two passes,
# the second through nat-GAN's g_loss_up), none for 'd_loss'
VARIANT_LAUNCHES = (2, 4)
TF_KERNELS = ("decoder_rows_kernel", "decoder_bwd_kernel")


def _graft(tree, r5):
    """`tree` with the leaves that the r5 tree also holds taken from it."""
    if not isinstance(tree, dict):
        return r5 if r5 is not None else tree
    return {k: _graft(v, r5.get(k) if isinstance(r5, dict) else None)
            for k, v in tree.items()}


def variant_train_txt(tmp, texts, cfg):
    """A train.txt over the r5 corpus's train rows under `tmp`, with
    synthetic labels: emotion i mod 4, speaker (i // 4) mod 8, dataset emt4
    on even rows and vctk on odd ones (both directories link the corpus).
    The labels exist only so that the feeder's reference and unpaired
    draws cross classes; the corpus has none."""
    for ds in ("emt4", "vctk"):
        os.symlink(os.path.join(R5, "corpus"), os.path.join(tmp, ds))
    hop = cfg.audio.effective_hop
    path = os.path.join(tmp, "train.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i, t in enumerate(texts[:N_TRAIN]):
            n = len(t) * int(0.06 * cfg.audio.sample_rate) // hop + 1
            f.write(f"{'vctk' if i % 2 else 'emt4'}|audio-{i}.npy|"
                    f"mel-{i}.npy|l|e|{n * hop}|{n}|{t}|{i % 4}|"
                    f"{(i // 4) % 8}|utt{i}.wav|F\n")
    return path


def variants_phase(tparams, stats, seed, smi):
    """Phase 26: the fork's Tacotron training modes on kernels 4a/4b."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tacotron2_tpu_torch.convert import (flax_named_parameters,
                                             init_tacotron, load_tacotron,
                                             tacotron_to_flax)
    from tacotron2_tpu_torch.data.feeder import TacotronFeeder
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    from tacotron2_tpu_torch.train.tacotron_step import (MODEL_FLAGS,
                                                         StepTimer,
                                                         TacotronTrainer)
    cfg = train_config()
    t0 = phase(26, f"(s) the fork's training modes: unpaired/intercross, "
               f"adversarial heads, nat-GAN, the refnet optimizer, "
               f"pretrained classifiers; emt_only; the paper preset (B="
               f"{TRAIN_BATCH}, T_in {PAD_TEXT}, {PAD_MEL} steps)")
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="variants_")
    feeder = TacotronFeeder(
        cfg, variant_train_txt(tmp, corpus_texts(), cfg), unpaired=True,
        intercross_both=True, batches_per_group=8,
        pad_text_multiple=PAD_TEXT, pad_mel_multiple=PAD_MEL, seed=seed)
    assert len(feeder.train_meta) == N_TRAIN, len(feeder.train_meta)
    batches = feeder.train_batches(TRAIN_BATCH)
    first = next(batches)
    assert first["inputs"].shape == (TRAIN_BATCH, PAD_TEXT)
    assert first["ref_mel_up_emt"].shape[:2] == (TRAIN_BATCH, PAD_MEL)
    print(f"feeder: {len(feeder.train_meta)} train rows, crossed labels "
          f"(emotion, speaker) of the first batch "
          f"{list(zip(first['emt_up_labels'], first['spk_up_labels']))[:4]}")

    # ---- (a) all on: the r5 weights, the new heads from a seeded draw
    mflags = {k: v for k, v in VARIANT_FLAGS.items() if k in MODEL_FLAGS}
    fresh = init_tacotron(cfg, torch.Generator().manual_seed(seed), "cpu",
                          **mflags)
    p0, s0 = tacotron_to_flax(fresh)
    model = load_tacotron(Tacotron(cfg, **mflags), _graft(p0, tparams),
                          _graft(s0, stats))
    trainer = TacotronTrainer(cfg, **VARIANT_FLAGS)
    state = trainer.init_state(model=model)
    named = flax_named_parameters(state.model)
    snap = lambda: [p.detach().clone() for _, p in named]
    moved = lambda a, b: [not torch.equal(x, y) for x, y in zip(a, b)]
    masks = {t: o.mask for t, o in state.optimizers()}
    print("optimizers (masked-on tensors): " + ", ".join(
        f"{t} {sum(m)}" for t, m in masks.items()) + f"; pretrained "
        f"{sum('pretrained' in n for n, _ in named)}, of {len(named)}")

    before = snap()
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    d_losses, d3 = [], []
    tk.train_launches = tk.bwd_launches = 0
    for _ in range(VARIANT_PRE_STEPS):
        state, dm = trainer.disc_pretrain_step(state, first, gen)
        d_losses.append(float(dm["d_loss"]))
        d3.append(sum(float(dm[k])
                      for k in ("d_loss_targ", "d_loss_p", "d_loss_up")))
    pre_launches = (tk.train_launches, tk.bwd_launches)
    changed = moved(before, snap())
    off = [n for (n, _), c in zip(named, changed) if c and "nat_gan" not in n]
    print(f"nat-GAN discriminator pretraining, {VARIANT_PRE_STEPS} steps on "
          f"one batch: d_loss " + " ".join(f"{x:.4f}" for x in d_losses)
          + "; its 3-class part " + " ".join(f"{x:.4f}" for x in d3)
          + f"; tensors moved {sum(changed)} (nat_gan "
          f"{sum(masks['d_loss'])}), outside nat_gan {off}; step "
          f"{state.step}; launches 4a {pre_launches[0]}, 4b "
          f"{pre_launches[1]}")
    # the gate is on d_loss's 3-class part, which the discriminator
    # minimises: its 0.1-weighted emotion and speaker terms reach the
    # encoder through gradient reversal, which trains it to raise them
    assert np.isfinite(d_losses).all() and d3[-1] < d3[0], d3
    assert not off and state.step == 0 and sum(changed) > 0
    assert pre_launches == (2 * VARIANT_PRE_STEPS, 0), pre_launches

    before = snap()
    steps, split, bad = [], {}, []
    tk.train_launches = tk.bwd_launches = 0
    for i in range(VARIANT_STEPS):
        timed = i >= 4
        trainer.timer = StepTimer() if timed else None
        torch.cuda.synchronize()
        ts = time.time()
        state, m = trainer.train_step(state, next(batches), gen)
        torch.cuda.synchronize()
        ms = 1e3 * (time.time() - ts)
        steps.append({k: float(v) for k, v in m.items()})
        bad += [(i, k) for k, v in steps[-1].items() if not np.isfinite(v)]
        if timed:
            for k, v in trainer.timer.totals().items():
                split[k] = split.get(k, 0.0) + v / 4
            split["step (host clock)"] = split.get(
                "step (host clock)", 0.0) + ms / 4
    trainer.timer = None
    launches = (tk.train_launches, tk.bwd_launches)
    changed = moved(before, snap())
    per_opt = {t: (sum(c for c, on in zip(changed, mk) if on), sum(mk))
               for t, mk in masks.items()}
    held = [n for (n, _), c in zip(named, changed)
            if "pretrained" in n and c]
    print(f"{VARIANT_STEPS} all-on train steps: loss " + " ".join(
        f"{s_['loss']:.4f}" for s_ in steps) + "; last step's terms " +
        ", ".join(f"{k} {v:.4f}" for k, v in steps[-1].items()))
    print(f"moved by each optimizer (tensors moved / masked on): {per_opt}; "
          f"pretrained tensors moved: {held}; kernel launches 4a "
          f"{launches[0]}, 4b {launches[1]} "
          f"({launches[0] / VARIANT_STEPS:g} / "
          f"{launches[1] / VARIANT_STEPS:g} a step)")
    assert not bad, bad
    assert all(got >= 0.9 * n for got, n in per_opt.values()), per_opt
    assert not held, held
    assert launches == tuple(VARIANT_STEPS * n for n in VARIANT_LAUNCHES)

    # the wrappers' counts of one more step against torch.profiler's
    n0 = (tk.train_launches, tk.bwd_launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.train_step(state, next(batches), gen)
        torch.cuda.synchronize()
    counted = (tk.train_launches - n0[0], tk.bwd_launches - n0[1])
    seen = tuple(sum(name in e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
                 for name in TF_KERNELS)
    print(f"one all-on step: launches counted by the wrappers {counted}, "
          f"seen by torch.profiler by kernel name {seen}")
    assert counted == seen == VARIANT_LAUNCHES, (counted, seen)

    split["rest of backward"] = (split["backward"]
                                 - split["backward (kernel 4b)"]
                                 - split["weight_grads"])
    base = STEP_SPLITS.get("phase 16", {})
    print(f"all-on bf16 step, ms (mean of steps 5-8; {smi}), beside phase "
          f"16's default step:")
    for k in ("step (host clock)", "memory pass forward",
              "train forward (kernel 4a)", "backward (kernel 4b)",
              "weight_grads", "rest of backward", "backward", "optimizer",
              "optimizer (refnet)", "optimizer (nat-GAN)"):
        print(f"  {k}: {split.get(k, 0.0):.3f}"
              + (f" (phase 16: {base[k]:.3f})" if k in base else ""))
    STEP_SPLITS["phase 26"] = dict(split)
    del state, trainer

    # ---- (b) the three gradients of one step in f32, fused route against
    # autograd through the plain decode, the same weights, batch and draws
    cfg32 = with_tacotron(cfg, fused_train_dtype="float32")
    trainer = TacotronTrainer(cfg32, **VARIANT_FLAGS)
    state = trainer.init_state(model=model)
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    got = {}
    for route in ("fused", "autograd", "replay"):
        for n, b in model.named_buffers():
            b.copy_(bufs[n])
        tk.train_launches = tk.bwd_launches = 0
        terms, _, grads, _ = trainer.step_gradients(
            state, first, torch.Generator(device=dev).manual_seed(seed),
            decode=route)
        got[route] = (float(terms["loss"].detach()), {
            t: torch.cat([x.flatten() for x in g if x is not None])
            for t, g in grads.items()}, (tk.train_launches, tk.bwd_launches))
    for n, b in model.named_buffers():
        b.copy_(bufs[n])
    errs = {ref: {t: float((got["fused"][1][t] - y).abs().max())
                  / float(y.abs().max()) for t, y in got[ref][1].items()}
            for ref in ("autograd", "replay")}
    print(f"f32 gradients (launches 4a, 4b: " + ", ".join(
        f"{r} {got[r][2]}" for r in got) + "; loss " + " / ".join(
        f"{got[r][0]:.6f}" for r in got) + "), max |fused - reference| / "
        "max |reference| per target: " + "; ".join(
            f"against {ref}: " + ", ".join(f"{t} {v:.2e}"
                                            for t, v in e.items())
            for ref, e in errs.items()))
    assert (got["fused"][2], got["autograd"][2], got["replay"][2]) == (
        VARIANT_LAUNCHES, (0, 0), (VARIANT_LAUNCHES[0], 0)), got
    assert set(errs["replay"]) == {"loss", "loss_no_mo_up", "d_loss"}
    assert max(errs["replay"].values()) <= VARIANT_GRAD_RTOL, errs
    del got, state, trainer, model

    # ---- (c) emt_only, then the paper preset's Tacotron, from a fresh init
    paper = cfg.replace(gst=dataclasses.replace(
        cfg.gst, use_gst=False, use_style_emb_disc=False,
        use_orthog_loss=False))
    for name, c, flags in (("emt_only", cfg, dict(emt_only=True)),
                           ("paper (use_gst=False)", paper, {})):
        trainer = TacotronTrainer(c, **flags)
        state = trainer.init_state(torch.Generator().manual_seed(seed))
        g_c = torch.Generator(device=dev).manual_seed(seed + 4)
        losses = []
        tk.train_launches = tk.bwd_launches = 0
        for _ in range(VARIANT_STEPS):
            state, m = trainer.train_step(state, first, g_c)
            losses.append(float(m["loss"]))
        print(f"{name}: {VARIANT_STEPS} steps on one batch from init_tacotron"
              f", memory width {state.model.memory_width}: loss " + " ".join(
                  f"{x:.4f}" for x in losses) + f"; launches 4a "
              f"{tk.train_launches}, 4b {tk.bwd_launches}")
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert (tk.train_launches, tk.bwd_launches) == (VARIANT_STEPS,
                                                       VARIANT_STEPS)
        del state, trainer
    shutil.rmtree(tmp, ignore_errors=True)
    done(26, t0)


# phase 28: the Tacotron variants (AdaIN with se_concat=False,
# predict_linear, emt_attn under training, GTA and embed, prenets other
# than (P, P)). Gates written before the first run on the card: the rows
# kernel with AdaIN's 640-wide memory by phase 5's replay gate; the f32
# fused gradient against decode="replay" within VARIANT_GRAD_RTOL (1e-4)
# of its largest magnitude, as phase 26; 4a/4b launches counted by the
# wrappers equal to torch.profiler's by kernel name (AdaIN: one each a
# step; the plain route: none). Card against CPU, the same plain decode
# on the same inputs and dropout multipliers with f32 weights (f32 sums in
# another order, no bf16 rounding to move): GTA and embed's mels, stop
# logits, alignments and embeddings, and the prenet variants' free-run
# frames, each within VARIANT_CPU_ATOL (the prediction: ~1e-5). The
# comparison runs the whole model in f32 (compute_dtype too: the r5
# config's bf16 encoder convs round differently on the two devices; the
# first reading, with them, was 1.07e-3 on emt_attn simple's decoder
# output and 3.7e-3 on its stop logits from the first step on).
VARIANT_CPU_ATOL = 1e-3
VARIANT_SYNTH_STEPS = 64
VARIANT_PLAIN_STEPS = 2
# the plain route's train batch: phase 16's first 16 rows, mels cut to
# this many frames (the plain decode is a Python loop of small launches);
# the step under torch.profiler takes 4 of them and a third of the frames
VARIANT_PLAIN_FRAMES = 64
VARIANT_GTA_FRAMES = 64
VARIANT_PRENETS = ((256, 128), (256, 256, 256))


def variant_weights(cfg, tparams, stats, seed):
    """`init_tacotron` weights for `cfg` (seeded), with the r5 checkpoint's
    leaves where path and shape agree for every leaf of the layer (a bias
    stays random where its kernel does), and LSTM1's hidden rows (and its
    prenet rows where the prenet's last width is r5's); the rest random.
    Returns (params, batch_stats, grafted, fresh)."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import convert
    model = convert.init_tacotron(cfg, torch.Generator().manual_seed(seed),
                                  "cpu")
    params, bstats = convert.tacotron_to_flax(model)
    grafted = fresh = 0
    r5_all = dict(_leaves(tparams, "params/"), **_leaves(stats, "stats/"))
    mine = dict(_leaves(params, "params/"), **_leaves(bstats, "stats/"))
    agree = lambda p: (r5_all.get(p) is not None
                       and np.shape(r5_all[p]) == mine[p].shape)
    layer = lambda p: p.split("/", 1)[1].rsplit("/", 1)[0]
    bad = {layer(p) for p in mine if not agree(p)}
    for path, leaf in mine.items():
        if layer(path) in bad:
            fresh += 1
            continue
        tree = params if path.startswith("params/") else bstats
        convert.tree_set(tree, path.split("/", 1)[1],
                         np.asarray(r5_all[path], np.float32))
        grafted += 1
    l1 = convert.tree_get(params, "decoder/cell/lstm1/kernel").copy()
    r5l1 = np.asarray(convert.tree_get(tparams, "decoder/cell/lstm1/kernel"))
    U, P = cfg.tacotron.decoder_lstm_units, cfg.tacotron.prenet_layers[-1]
    l1[-U:] = r5l1[-U:]
    if P == 256:
        l1[:P] = r5l1[:P]
    convert.tree_set(params, "decoder/cell/lstm1/kernel", l1)
    return params, bstats, grafted, fresh


def hold_card_cpu(name, diffs):
    """The card-against-CPU gate above on {output: |card - CPU|}: frames
    and stop values [B, steps·r(, ·)], alignments [B, ·, steps] (printed
    by 16-step window) and the reference encoders' embeddings."""
    rows = []
    for k, d in diffs.items():
        by = ""
        if not k.startswith("refnet"):
            steps = d.shape[-1] if k.startswith("alignments") else d.shape[1]
            win = ((lambda a: d[..., a:a + 16]) if k.startswith("alignments")
                   else (lambda a: d[:, a:a + 16]))
            by = " (by 16 steps " + " ".join(
                f"{float(win(a).max()):.1e}" for a in range(0, steps, 16)) \
                + ")"
        rows.append(f"{k} {float(d.max()):.2e}{by}")
    print(f"{name}, card against CPU (f32): " + "; ".join(rows))
    worst = {k: float(d.max()) for k, d in diffs.items()}
    assert max(worst.values()) <= VARIANT_CPU_ATOL, (name, worst)


def tf_kernel_events(fn):
    """Run fn under torch.profiler -> its 4a and 4b launches by kernel
    name (TF_KERNELS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return tuple(sum(name in e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
                 for name in TF_KERNELS)


def variant_cases_phase(texts, ref_list, tparams, stats, seed, smi):
    """Phase 28: the Tacotron variants on their routes."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.convert import load_tacotron
    from tacotron2_tpu_torch.eval.convergence import batch_from_rows
    from tacotron2_tpu_torch.models.tacotron.decoder import (
        WHOLE, teacher_forced, teacher_forced_route)
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    from tacotron2_tpu_torch.synth.tacotron_synth import (
        TacotronSynthesizer, plain_synthesis)
    from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer
    t0 = phase(28, "(u) the Tacotron variants: AdaIN with se_concat=False, "
               "predict_linear, emt_attn training, GTA and embed, prenets "
               f"{VARIANT_PRENETS}")
    base = train_config()
    B = len(texts)
    dev = torch.device("cuda")
    corpus = corpus_texts()
    mel_dir = os.path.join(R5, "corpus", "mels")
    rows = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
            for i, t in enumerate(corpus)]
    first = batch_from_rows(rows[:TRAIN_BATCH], mel_dir, base,
                            pad_text_to=PAD_TEXT, pad_mel_to=PAD_MEL)
    def cut(rows_, frames):
        b = {k: v[:rows_] for k, v in first.items()}
        for k in ("mel_targets", "stop_token_targets"):
            b[k] = b[k][:, :frames]
        b["targets_lengths"] = np.minimum(b["targets_lengths"], frames)
        return b

    F = VARIANT_PLAIN_FRAMES
    short, probe = cut(TRAIN_BATCH, F), cut(4, F // 3)
    seconds = {}

    def setup(name, **over):
        cfg = base
        for sec, kw in over.items():
            cfg = cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec),
                                                          **kw)})
        params, bstats, ng, nf = variant_weights(cfg, tparams, stats, seed)
        print(f"{name}: {ng} tensors from r5, {nf} random; teacher-forced "
              f"route {teacher_forced_route(cfg)}, free-running route "
              f"{'plain' if plain_synthesis(cfg) else 'kernel'}")
        return cfg, params, bstats

    def train(cfg, params, bstats, batch, n, gen_seed, probe_batch=None):
        """n steps on `batch` -> (terms a step, their 4a/4b launches); with
        `probe_batch` one more step on it under torch.profiler, and its
        launches counted by the wrappers and seen in the trace."""
        trainer = TacotronTrainer(cfg)
        state = trainer.init_state(model=load_tacotron(
            Tacotron(cfg), params, bstats))
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        terms = []
        tk.train_launches = tk.bwd_launches = 0
        for _ in range(n):
            state, m = trainer.train_step(state, batch, gen)
            terms.append({k: float(v) for k, v in m.items()})
        launches = (tk.train_launches, tk.bwd_launches)
        if probe_batch is None:
            return terms, launches, None
        seen = tf_kernel_events(
            lambda: trainer.train_step(state, probe_batch, gen))
        counted = (tk.train_launches - launches[0],
                   tk.bwd_launches - launches[1])
        return terms, launches, (counted, seen)

    # ---- (a) AdaIN with se_concat=False: the rows kernel, 4a and 4b
    ts = time.time()
    cfg, params, bstats = setup("AdaIN, se_concat=False",
                                gst=dict(adain=True, se_concat=False))
    synth = TacotronSynthesizer(cfg, params, bstats, device="cuda",
                                seed=seed, keep_intermediates=True)
    dk.rows_launches = dk.launches = 0
    out = synth.synthesize(texts, ref_list, ref_list, max_steps=MAX_STEPS)
    im = synth.intermediates
    Bm, T, M = im["memory"].shape
    print(f"AdaIN synthesis of the {B} texts: route {im['route']}, memory "
          f"width {M}, rows-kernel launches {dk.rows_launches}, decoder.cu "
          f"{dk.launches}; stop steps {[int(x) for x in out['lengths']]}")
    assert im["route"] == "fused" and M == 640 and dk.rows_launches > 0
    assert dk.launches == 0
    assert all(np.isfinite(m_).all() for m_ in out["mels"])
    dargs = (synth.dec_params, cfg, im["keys"], im["memory"], im["mask"])
    st0 = dk.init_decoder_state(cfg, Bm, T, M, "cuda")
    d32 = im["drop"][:, :32].contiguous()
    full = dk.decode_block(*dargs, st0, d32, casts=WHOLE,
                           kernel_weights=synth.dec_kernel)
    replay_gate(
        "AdaIN rows kernel over the first 32 steps",
        lambda st, d: dk.decode_block(*dargs, st, d, casts=WHOLE,
                                      kernel_weights=synth.dec_kernel),
        lambda st, d: dk.decode_block_plain(*dargs, st, d, casts=WHOLE),
        lambda st, d: dk.decode_block_plain(
            f32_activations(dargs[0]), *dargs[1:], st, d),
        st0, d32, full)
    del synth
    terms, launches, (counted, seen) = train(
        cfg, params, bstats, first, 3, seed + 5, probe_batch=probe)
    print(f"AdaIN: 3 train steps at phase 16's shapes, loss " + " ".join(
        f"{t_['loss']:.4f}" for t_ in terms) + f"; launches 4a, 4b "
        f"{launches}; a fourth step's counted {counted}, seen by "
        f"torch.profiler {seen}")
    assert all(np.isfinite(list(t_.values())).all() for t_ in terms)
    assert launches == (3, 3) and counted == seen == (1, 1), (
        launches, counted, seen)
    cfg32 = with_tacotron(cfg, fused_train_dtype="float32")
    trainer = TacotronTrainer(cfg32)
    model = load_tacotron(Tacotron(cfg32), params, bstats).to(dev)
    state = trainer.init_state(model=model)
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    got = {}
    for route in ("fused", "replay"):
        for n, b in model.named_buffers():
            b.copy_(bufs[n])
        _, _, grads, _ = trainer.step_gradients(
            state, short, torch.Generator(device=dev).manual_seed(seed),
            decode=route, targets=["loss"])
        got[route] = torch.cat([x.flatten() for x in grads["loss"]])
    err = rel_err(got["fused"], got["replay"])
    print(f"AdaIN f32 step (B {TRAIN_BATCH}, {F} frames): max |fused - "
          f"replay| / max |replay| of the 'loss' gradient {err:.2e} (gate "
          f"{VARIANT_GRAD_RTOL:g})")
    assert err <= VARIANT_GRAD_RTOL, err
    del got, state, trainer, model
    seconds["AdaIN"] = time.time() - ts
    print(f"AdaIN: {seconds['AdaIN']:.3f} s", flush=True)

    # ---- (b) predict_linear on seeded linear targets
    ts = time.time()
    cfg, params, bstats = setup("predict_linear",
                                tacotron=dict(predict_linear=True))
    lin = dict(first)
    lin["linear_targets"] = np.random.default_rng(seed).uniform(
        -4.0, 4.0, first["mel_targets"].shape[:2] + (cfg.audio.num_freq,)
    ).astype(np.float32)
    terms, launches, _ = train(cfg, params, bstats, lin, 4, seed + 6)
    ll = [t_["linear_loss"] for t_ in terms]
    print(f"predict_linear: 4 steps on one batch with linear targets "
          f"{lin['linear_targets'].shape}: linear_loss " + " ".join(
              f"{x:.4f}" for x in ll) + f"; loss " + " ".join(
              f"{t_['loss']:.4f}" for t_ in terms) + f"; launches 4a, 4b "
          f"{launches}")
    assert np.isfinite(ll).all() and ll[-1] < ll[0], ll
    assert launches == (4, 4), launches
    seconds["predict_linear"] = time.time() - ts
    print(f"predict_linear: {seconds['predict_linear']:.3f} s", flush=True)

    # ---- (c) emt_attn: training, GTA and embed on the plain route
    tgts = [m_[:VARIANT_GTA_FRAMES] for m_ in ref_list]
    for kind in EMT_TYPES:
        ts = time.time()
        cfg, params, bstats = setup(
            f"emt_attn {kind}", gst=dict(emt_attn=True, emt_attn_type=kind,
                                         l2_spk_emb=True))
        terms, launches, (counted, seen) = train(
            cfg, params, bstats, short, VARIANT_PLAIN_STEPS, seed + 7,
            probe_batch=probe)
        print(f"emt_attn {kind}: {VARIANT_PLAIN_STEPS} train steps (B "
              f"{TRAIN_BATCH}, {F} frames), loss " + " ".join(
                  f"{t_['loss']:.4f}" for t_ in terms) + f" (l2_spk_emb "
              f"{terms[-1]['style_emb_orthog_loss']:.4f}); launches 4a, 4b "
              f"{launches}; a step under torch.profiler counted {counted}, "
              f"seen {seen}")
        assert all(np.isfinite(list(t_.values())).all() for t_ in terms)
        assert launches == (0, 0) and counted == seen == (0, 0)
        labels = ([i % cfg.gst.n_emt for i in range(B)]
                  if kind == "style_tokens" else None)
        synth = TacotronSynthesizer(cfg, params, bstats, device="cuda",
                                    seed=seed, keep_intermediates=True)
        tk.launches = 0
        g_out = synth.synthesize(texts, ref_list, ref_list, mel_targets=tgts,
                                 gta=True, emt_labels=labels)
        emb = synth.embed(texts, tgts)
        print(f"emt_attn {kind}: GTA route {synth.intermediates['route']}, "
              f"eval-kernel launches {tk.launches}; alignments_emt "
              f"{g_out['alignments_emt'][0].shape}; embed "
              f"{ {k: getattr(v, 'shape', None) for k, v in emb.items()} }")
        assert synth.intermediates["route"] == "teacher_forced_plain"
        assert tk.launches == 0
        assert all(np.isfinite(m_).all() for m_ in g_out["mels"])
        ids, lens = synth.prepare_inputs(texts)
        tg, refs = np.stack(tgts), synth._pad_refs(ref_list)
        del synth
        # the same GTA and embed passes on the card and on the CPU: f32
        # weights, the same dropout multipliers
        c32 = with_tacotron(cfg, fused_train_dtype="float32",
                            compute_dtype="float32")
        drop = torch.rand(B, VARIANT_GTA_FRAMES, 2, 256,
                          generator=torch.Generator().manual_seed(seed))
        drop = (drop < 0.5).float() * 2.0
        res = {}
        for where in ("cuda", "cpu"):
            model = load_tacotron(Tacotron(c32), params, bstats).to(
                where).eval().requires_grad_(False)
            dp = tk.cast_params(tk.extract_params_traced(model.decoder, c32),
                                torch.float32)
            coins = torch.ones(VARIANT_GTA_FRAMES, dtype=torch.int32)
            d = drop.to(where)

            def decode(keys, memory, mask, teacher, emt):
                f, s, a, e = teacher_forced(dp, c32, keys, memory, mask,
                                            teacher, coins, d, emt=emt)
                return f, s, a, e

            t = lambda x, dt=torch.float32: torch.as_tensor(
                np.asarray(x), device=where, dtype=dt)
            lab = None if labels is None else t(labels, torch.long)
            gta = model.gta_pass(t(ids, torch.long), t(lens, torch.long),
                                 t(tg), t(refs), t(refs), decode,
                                 synth_embeddings=True, emt_labels=lab)
            res[where] = {k: v.float().cpu() for k, v in gta.items()
                          if v is not None}
        assert set(res["cpu"]) == set(res["cuda"])
        diffs = {k: (res["cuda"][k] - v).abs() for k, v in res["cpu"].items()}
        hold_card_cpu(f"emt_attn {kind}: GTA and embed", diffs)
        seconds[f"emt_attn {kind}"] = time.time() - ts
        print(f"emt_attn {kind}: {seconds[f'emt_attn {kind}']:.3f} s",
              flush=True)

    # ---- (d) prenets other than (P, P): the plain route throughout
    for layers in VARIANT_PRENETS:
        ts = time.time()
        cfg, params, bstats = setup(
            f"prenet {layers}", tacotron=dict(prenet_layers=layers,
                                              fused_decoder_dtype="float32"))
        synth = TacotronSynthesizer(cfg, params, bstats, device="cuda",
                                    seed=seed, keep_intermediates=True)
        dk.rows_launches = dk.launches = 0
        out = synth.synthesize(texts, ref_list, ref_list,
                               max_steps=VARIANT_SYNTH_STEPS)
        im = synth.intermediates
        kernels = (dk.rows_launches, dk.launches)
        K = cfg.tacotron.early_stop_block
        args = lambda dev_: [x.to(dev_) for x in (
            im["keys"], im["memory"], im["mask"])]
        f_g, s_g, _ = dk.decode_plain(
            synth.dec_params, cfg, *args("cuda"), im["drop"],
            steps=VARIANT_SYNTH_STEPS, early_stop_block=K,
            prenet=synth.prenet)
        cpu_p = [(w.cpu(), b.cpu()) for w, b in synth.prenet]
        dp_c = type(synth.dec_params)(*[None if x is None else x.cpu()
                                        for x in synth.dec_params])
        f_c, s_c, _ = dk.decode_plain(
            dp_c, cfg, *args("cpu"), im["drop"].cpu(),
            steps=VARIANT_SYNTH_STEPS, early_stop_block=K, prenet=cpu_p)
        print(f"prenet {layers}: synthesis route {im['route']}, drop "
              f"{tuple(im['drop'].shape)}, decode-kernel launches (rows, "
              f"decoder.cu) {kernels}; {VARIANT_SYNTH_STEPS} steps")
        assert im["route"] == "plain" and kernels == (0, 0)
        assert all(np.isfinite(m_).all() for m_ in out["mels"])
        hold_card_cpu(f"prenet {layers}: free run", {
            "decoder_output": (f_g.cpu() - f_c).abs(),
            "stop_token_prediction": (s_g.cpu() - s_c).abs()})
        del synth
        terms, launches, (counted, seen) = train(
            cfg, params, bstats, short, VARIANT_PLAIN_STEPS, seed + 8,
            probe_batch=probe)
        print(f"prenet {layers}: {VARIANT_PLAIN_STEPS} train steps, loss "
              + " ".join(f"{t_['loss']:.4f}" for t_ in terms)
              + f"; launches 4a, 4b {launches}, seen {seen}")
        assert all(np.isfinite(list(t_.values())).all() for t_ in terms)
        assert launches == (0, 0) and counted == seen == (0, 0)
        seconds[f"prenet {layers}"] = time.time() - ts
        print(f"prenet {layers}: {seconds[f'prenet {layers}']:.3f} s",
              flush=True)
    print(f"phase 28 seconds ({smi}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    torch.cuda.empty_cache()
    done(28, t0)


# phase 27: the style discriminators and their graft into Tacotron
# training, at the r5 config's full width (default GST widths: reference
# filters (32, 32, 64, 64, 128, 128), GRU 128) over phase 26's train.txt
# (synthetic labels: emotion i mod 4, speaker (i // 4) mod 8). (b)'s
# tolerances, written before the first reading: one CE step of the same
# weights and batch on the card and on the CPU, f32 (TF32 off) in another
# sum order. The embeddings (unit vectors) within DISC_EMB_ATOL; each
# gradient within DISC_GRAD_RTOL of its tensor's largest, but the conv
# biases right before train-mode BatchNorm, whose gradient is zero in
# exact arithmetic (rounding noise on both sides), within
# DISC_NOISE_REL of the largest gradient of any tensor; the running
# statistics the step moved within DISC_STAT_RTOL of their scale; the
# parameters after Adam's first step (lr·g/(|g| + 1e-8): lr·sign(g) for
# any but tiny |g|) within DISC_PARAM_ATOL, but the elements whose CPU
# gradient lies within 10× their tensor's card-CPU gradient difference
# (a sign that rounding may flip) within 2·lr, the most Adam's first step
# lets any element differ; so that this exemption cannot widen with a
# wrong gradient, at most DISC_FLIP_SHARE of each tensor's elements take
# it (the conv biases before BatchNorm, all noise, excepted; written
# before its first reading). The first reading on an
# H100 missed DISC_NOISE_REL, then 1e-5: conv2d_0's bias read
# 2.15e-5 (conv2d_1's 1.9e-6, the deeper ones less), everything else
# within its tolerance (gradients 1.05e-4, statistics 3.5e-7, embeddings
# 4.6e-7). Such a bias sums the cancelling gradients of every position of
# its layer (81,920 for conv2d_0 at B 32), so its noise grows with them;
# the gate has been 1e-4 since.
DISC_EMB_ATOL = 1e-4
DISC_GRAD_RTOL = 1e-3
DISC_NOISE_REL = 1e-4
DISC_STAT_RTOL = 1e-4
DISC_PARAM_ATOL = 1e-6
DISC_FLIP_SHARE = 0.05
DISC_STEPS, EMT_DISC_STEPS, STACK_STEPS, GRAFT_STEPS = 200, 40, 50, 4
OVERFIT_STEPS, OVERFIT_ROWS = 20, 8
STYLE_ROWS = 16


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def disc_phase(seed, smi):
    """Phase 27: `disc-train` (CE and GE2E), a disc step on the card
    against the CPU, `emt-disc-train`, `disc-preprocess` and GE2E on its
    stacks, Tacotron training with the grafted discriminators (summaries,
    output vars, a torch.profiler window), style-transfer synthesis on
    kernel 1 classified by `disc-test`, and `overfit`."""
    import copy

    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli, convert
    from tacotron2_tpu_torch.data.audio import save_wav
    from tacotron2_tpu_torch.disc import model as dm
    from tacotron2_tpu_torch.disc import train as dt
    from tacotron2_tpu_torch.eval.convergence import batch_from_rows, overfit
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    from tacotron2_tpu_torch.train.checkpoint import CheckpointManager
    from tacotron2_tpu_torch.train.tacotron_train import \
        import_pretrained_disc
    cfg = train_config()
    t0 = phase(27, "(t) the style discriminators: disc-train (CE, GE2E), "
               "a disc step card vs CPU, emt-disc-train, disc-preprocess "
               "and GE2E on its stacks, Tacotron training with the grafted "
               "discriminators, style transfer classified by disc-test, "
               "overfit")
    tmp = tempfile.mkdtemp(prefix="discs_")
    texts = corpus_texts()
    train_txt = variant_train_txt(tmp, texts, cfg)
    hp = "tacotron.compute_dtype=bfloat16,audio.trim_silence=false"
    secs = {}

    def curve(path):
        return [json.loads(x) for x in open(path, encoding="utf-8")]

    # ---- (a) disc-train: emotion CE, speaker GE2E softmax. The labels
    # are synthetic and carry no signal (the CE loss sits near ln 4), so
    # the falling loss shows only that the rows are memorized.
    discs = {}
    for kind, loss_type in (("emt", "ce"), ("spk", "softmax")):
        ts = time.time()
        discs[kind] = cli.main([
            "--hparams", hp, "disc-train", "--input-path", train_txt,
            "--base-dir", tmp, "--kind", kind, "--loss-type", loss_type,
            "--train-steps", str(DISC_STEPS)])
        secs[f"disc-train {kind}"] = time.time() - ts
        losses = [r["loss"] for r in curve(os.path.join(
            tmp, f"disc_{kind}_curve.jsonl"))]
        first, last = np.mean(losses[:20]), np.mean(losses[-20:])
        print(f"disc-train --kind {kind} --loss-type {loss_type}: "
              f"{len(losses)} steps in {secs[f'disc-train {kind}']:.3f} s, "
              f"loss mean of the first 20 {first:.4f}, of the last 20 "
              f"{last:.4f}; checkpoints {os.listdir(discs[kind])}")
        assert len(losses) == DISC_STEPS and np.isfinite(losses).all()
        assert last < first, (kind, first, last)

    # ---- (b) one CE step on the card against the same step on the CPU
    ts = time.time()
    feeder = dt.DiscFeeder(cfg, train_txt, kind="emt", seed=seed)
    b = next(feeder.batches(M=8))
    base = dm.DiscriminatorModel(cfg, feeder.n_classes)
    convert.init_params(base, cfg, torch.Generator().manual_seed(seed))
    got = {}
    for dev in ("cuda", "cpu"):
        tr = dt.DiscTrainer(copy.deepcopy(base).to(dev), feeder.n_classes,
                            use_ce=True)
        loss, _, emb = tr.loss(b["mels"], b["labels"], b["N"], b["M"])
        grads = torch.autograd.grad(loss, tr.params)
        tr.opt.step(tr.params, grads)
        params, stats = convert.disc_to_flax(tr.model)
        names = [convert.flax_path(n) for n, _ in tr.model.named_parameters()]
        got[dev] = dict(loss=float(loss.detach()),
                        emb=emb.detach().cpu().numpy(),
                        grads={n: convert.to_flax_array(m, g) for n, (m, _), g
                               in zip(names, tr.model.named_parameters(),
                                      grads)},
                        params=_flat(params), stats=_flat(stats))
    c, h = got["cuda"], got["cpu"]
    lr = tr.opt.lr
    emb_err = float(np.abs(c["emb"] - h["emb"]).max())
    g_top = max(float(np.abs(g).max()) for g in h["grads"].values())
    noise = {n for n in h["grads"] if re.search(r"conv2d_\d+/bias$", n)}
    g_err, p_err, share, flips = {}, {}, {}, 0
    for n, g in h["grads"].items():
        d = np.abs(c["grads"][n] - g)
        g_err[n] = float(d.max()) / (g_top if n in noise
                                     else max(float(np.abs(g).max()), 1e-30))
        flip = np.abs(g) <= 10 * d.max()
        tol = np.where(flip, 2 * lr, DISC_PARAM_ATOL)
        e = np.abs(c["params"][n] - h["params"][n])
        flips += int(flip.sum())
        if n not in noise:
            share[n] = float(flip.mean())
        p_err[n] = float((e / tol).max())
    s_err = {n: float(np.abs(c["stats"][n] - v).max()
                      / max(float(np.abs(v).max()), 1e-30))
             for n, v in h["stats"].items()}
    worst = max(share, key=share.get)
    secs["card vs CPU step"] = time.time() - ts
    print(f"one CE step, card vs CPU (B {len(b['labels'])} crops of 128 "
          f"frames): loss {c['loss']:.6f} / {h['loss']:.6f}; embeddings max "
          f"|diff| {emb_err:.2e}; gradients, max |diff| / scale: largest "
          f"{max(v for n, v in g_err.items() if n not in noise):.2e}, conv "
          f"biases before BatchNorm {max(g_err[n] for n in noise):.2e} of "
          f"the largest gradient; statistics {max(s_err.values()):.2e}; "
          f"parameters, worst share of the tolerance {max(p_err.values()):.3f}"
          f" ({flips} elements of near-zero gradient held to 2·lr = "
          f"{2 * lr:g}; the largest share of such elements outside the "
          f"noise-only biases {share[worst]:.4f}, {worst})")
    assert emb_err <= DISC_EMB_ATOL, emb_err
    assert all(v <= (DISC_NOISE_REL if n in noise else DISC_GRAD_RTOL)
               for n, v in g_err.items()), g_err
    assert max(s_err.values()) <= DISC_STAT_RTOL, s_err
    assert max(p_err.values()) <= 1.0, p_err
    assert share[worst] <= DISC_FLIP_SHARE, (worst, share[worst])

    # ---- (c) emt-disc-train with its val line every 10 steps
    ts = time.time()
    e_dir = cli.main(["--hparams", hp, "emt-disc-train", "--input-path",
                      train_txt, "--base-dir", tmp, "--train-steps",
                      str(EMT_DISC_STEPS)])
    secs["emt-disc-train"] = time.time() - ts
    recs = curve(os.path.join(tmp, "emt_disc_curve.jsonl"))
    vals = [(r["step"], round(r["val_loss"], 4), round(r["val_acc"], 3))
            for r in recs if "val_loss" in r]
    print(f"emt-disc-train: {len(recs)} steps in {secs['emt-disc-train']:.3f}"
          f" s, (step, val loss, val acc) {vals}; checkpoints "
          f"{sorted(os.listdir(e_dir))}")
    assert len(recs) == EMT_DISC_STEPS and [v[0] for v in vals] == [
        10, 20, 30, 40]
    assert np.isfinite([r["loss"] for r in recs] + [v[1] for v in vals]).all()

    # ---- (d) disc-preprocess on the r5 audio of rows 0-15 as wavs (two
    # speakers of 8), then GE2E on its stacks
    ts = time.time()
    a = cfg.audio
    for i in range(16):
        d = os.path.join(tmp, "speakers", f"spk{i // 8}")
        os.makedirs(d, exist_ok=True)
        save_wav(np.load(os.path.join(R5, "corpus", "audio",
                                      f"audio-{i}.npy")),
                 os.path.join(d, f"utt{i}.wav"), a.sample_rate)
    out = cli.main(["--hparams", hp, "disc-preprocess", "--corpus-dir",
                    os.path.join(tmp, "speakers"), "--output-dir",
                    os.path.join(tmp, "tisv"), "--test-fraction", "0"])
    shapes = [np.load(os.path.join(out["train"], f"speaker{i}.npy")).shape
              for i in range(2)]
    s_dir = cli.main(["--hparams", hp, "disc-train", "--stacks-dir",
                      out["train"], "--base-dir", os.path.join(tmp, "st"),
                      "--kind", "spk", "--train-steps", str(STACK_STEPS),
                      "--n-per-class", "4"])
    st_loss = [r["loss"] for r in curve(os.path.join(
        tmp, "st", "disc_spk_curve.jsonl"))]
    secs["disc-preprocess + stacks"] = time.time() - ts
    print(f"disc-preprocess: stacks {shapes} ([windows, 40 mels, 140 "
          f"frames]); disc-train --stacks-dir {STACK_STEPS} steps: loss "
          f"{st_loss[0]:.4f} -> {st_loss[-1]:.4f}, "
          f"{secs['disc-preprocess + stacks']:.3f} s; {os.listdir(s_dir)}")
    assert all(sh[0] > 0 and sh[1:] == (40, 140) for sh in shapes), shapes
    assert len(st_loss) == STACK_STEPS and np.isfinite(st_loss).all()

    # ---- (e) Tacotron training with the grafted discriminators
    fresh = convert.init_tacotron(cfg, torch.Generator().manual_seed(seed),
                                  "cpu", pretrained_emb_disc=True,
                                  use_unpaired=True)
    want = {k: dt.load_pretrained_disc(d) for k, d in discs.items()}

    def held(params, stats, when):
        for kind, w in want.items():
            sc = f"pretrained_ref_enc_{kind}"
            for tree, sub in ((params, w["params"]),
                              (stats, w["batch_stats"])):
                g = _flat(convert.tree_get(tree, sc))
                for k, v in _flat(sub).items():
                    assert np.array_equal(g[k], v), (when, sc, k)
    for kind, d in discs.items():
        import_pretrained_disc(fresh, kind, d)
    held(*convert.tacotron_to_flax(fresh), "grafted")
    ts = time.time()
    tk.train_launches = tk.bwd_launches = tk.launches = 0
    base_dir = os.path.join(tmp, "taco")
    ckpt_dir = cli.main([
        "--hparams", hp + ",train.summary_interval=1", "train", "--model",
        "Tacotron",
        "--input-path", train_txt, "--base-dir", base_dir, "--train-steps",
        str(GRAFT_STEPS), "--batch-size", str(TRAIN_BATCH),
        "--eval-interval", "0", "--unpaired", "--pretrained-emb-disc",
        "--pretrained-disc-emt", discs["emt"], "--pretrained-disc-spk",
        discs["spk"], "--save-output-vars", "--profile-start", "2",
        "--profile-end", "4"])
    secs["graft train"] = time.time() - ts
    counted = (tk.train_launches, tk.bwd_launches)
    mgr = CheckpointManager(ckpt_dir)
    assert mgr.steps() == [GRAFT_STEPS], mgr.steps()
    tree = mgr.load()
    held(tree["params"], tree["batch_stats"], f"step {GRAFT_STEPS}")
    log_dir = os.path.dirname(ckpt_dir)
    rows = [json.loads(x) for x in open(os.path.join(log_dir,
                                                     "metrics.jsonl"))]
    log = open(os.path.join(log_dir, "train.log")).read()
    ov = sorted(os.listdir(os.path.join(log_dir, "output_vars")))
    trace_path = os.path.join(log_dir, "profile", "trace-2.json")
    events = json.load(open(trace_path))["traceEvents"]
    seen = tuple(sum(1 for e in events
                     if str(e.get("cat", "")).lower() == "kernel"
                     and k in e.get("name", "")) for k in TF_KERNELS)
    per_step = tuple(n // GRAFT_STEPS for n in counted)
    curve_t = curve(os.path.join(log_dir, "taco_curve.jsonl"))
    # each step's host-clock seconds from the running mean the loop logs
    avg = [r["tacotron/sec_per_step"] for r in rows
           if "tacotron/sec_per_step" in r]
    step_ms = [1e3 * ((k + 1) * v - k * (avg[k - 1] if k else 0.0))
               for k, v in enumerate(avg)]
    print(f"cli train --unpaired --pretrained-emb-disc with the grafted "
          f"discriminators, {GRAFT_STEPS} steps in {secs['graft train']:.3f}"
          f" s; step ms (host clock, 3-4 under the profiler; {smi}) "
          + " ".join(f"{x:.3f}" for x in step_ms) + "; loss " + " ".join(
              f"{r['loss']:.4f}" for r in curve_t) + f"; launches 4a, 4b "
          f"{counted} ({per_step} a step), the trace of steps 3-4 by "
          f"kernel name {seen}; metrics.jsonl {len(rows)} rows, output_vars "
          f"{ov}, grafted encoders and statistics equal the discs' at the "
          f"graft and at step {GRAFT_STEPS}")
    assert counted == (2 * GRAFT_STEPS, 2 * GRAFT_STEPS), counted
    assert seen == tuple(2 * n for n in per_step), (seen, per_step)
    assert sorted({r["step"] for r in rows}) == list(
        range(1, GRAFT_STEPS + 1))
    assert "Imported pretrained spk discriminator (msgpack)" in log
    assert {"mels-1.csv", "align-1.csv", "stop-1.csv"} <= set(ov)

    # ---- (f) style-transfer synthesis of 16 rows on kernel 1, then
    # disc-test with (a)'s emotion discriminator on its map.txt
    ts = time.time()
    dk.rows_launches = 0
    map_path = cli.main([
        "--hparams", hp + f",tacotron.max_iters={MAX_STEPS}", "synthesize",
        "--model", "Tacotron", "--mode", "synthesis", "--input-path",
        train_txt, "--limit", str(STYLE_ROWS), "--checkpoint",
        os.path.join(R5, "taco_ckpt.msgpack"), "--output-dir",
        os.path.join(tmp, "style"), "--seed", str(seed)])
    k1 = dk.rows_launches
    acc, cm = cli.main(["--hparams", hp, "disc-test", "--checkpoint",
                        discs["emt"], "--map-path", map_path, "--kind",
                        "emt", "--base-dir", tmp])
    secs["style transfer + disc-test"] = time.time() - ts
    # the same checkpoint on the same mels on the CPU: the same predictions
    acc_h, cm_h = cli.main(["--hparams", hp, "disc-test", "--checkpoint",
                            discs["emt"], "--map-path", map_path, "--kind",
                            "emt", "--base-dir", tmp, "--output-dir",
                            os.path.join(tmp, "disc_test_cpu"), "--device",
                            "cpu"])

    def csv_of(sub):
        return open(os.path.join(tmp, sub, "disc_test_emt.csv")
                    ).read().strip().split("\n")[1:]
    csv_rows, csv_h = csv_of("disc_test"), csv_of("disc_test_cpu")
    same = sum(a_ == b_ for a_, b_ in zip(csv_rows, csv_h))
    plot = os.path.exists(os.path.join(tmp, "disc_test", "confusion_emt.png"))
    print(f"synthesize --mode synthesis, {STYLE_ROWS} rows: kernel 1 "
          f"launches {k1}; disc-test --kind emt: acc {acc:.4f}, confusion "
          f"matrix {cm.tolist()}, {len(csv_rows)} CSV rows, predictions "
          f"equal to the CPU's in {same} of {len(csv_h)} rows (CPU acc "
          f"{acc_h:.4f}), confusion plot "
          f"{'written' if plot else 'skipped (no matplotlib)'}; "
          f"{secs['style transfer + disc-test']:.3f} s")
    assert k1 > 0 and cm.sum() == STYLE_ROWS
    assert len(csv_rows) == STYLE_ROWS and csv_rows == csv_h, (csv_rows,
                                                                csv_h)
    assert np.array_equal(cm, cm_h) and acc == acc_h
    assert acc == np.trace(cm) / STYLE_ROWS, (acc, cm)

    # ---- (g) overfit one r5 batch of 8
    ts = time.time()
    rows_o = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
              for i, t in enumerate(texts[:OVERFIT_ROWS])]
    batch = batch_from_rows(rows_o, os.path.join(R5, "corpus", "mels"), cfg,
                            pad_text_to=PAD_TEXT, pad_mel_to=PAD_MEL)
    rep, hist = overfit(cfg, batch, OVERFIT_STEPS, seed=seed, eval_every=10,
                        device="cuda")
    secs["overfit"] = time.time() - ts
    print(f"overfit, {OVERFIT_STEPS} steps on {OVERFIT_ROWS} r5 rows: "
          f"history (step, loss, mel MAE, diagonality) " + ", ".join(
              f"({s_}, {l_:.4f}, {m_:.4f}, {d_:.3f})"
              for s_, l_, m_, d_ in hist) + f"; {secs['overfit']:.3f} s")
    assert [h_[0] for h_ in hist] == [1, 10, 20], hist
    assert np.isfinite([h_[1] for h_ in hist]).all()
    assert hist[-1][1] < hist[0][1], hist
    print("phase 27 seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in secs.items()))
    shutil.rmtree(tmp, ignore_errors=True)
    done(27, t0)


# phase 29: the WaveNet variants at the r5 widths (20 layers, R 128, G 256,
# S 128, bf16 stack compute, hop 200 = (8, 25)) on seeded init_wavenet
# weights grafted with the r5 EMA checkpoint's where path and shape agree.
# The upsample on the card against the CPU's in f32 (TF32 off on both: the
# same function in another sum order) within WN_VAR_UP_RTOL of max(1, the
# CPU output's largest magnitude); 2 train steps at phase 19's shapes;
# the sampler over the first SAMPLER_WINDOW samples of WN_VAR_FRAMES
# frames of the 8 held-out mels, held by phase 5's replay gate
# (`hold_variant_samplers`); from the grafted weights the first Adam step
# lifts the loss to the hundreds (ROADMAP.md queue 3), so the steps hold
# finiteness only; kernel_size 2's plain
# sampler on the card against the same plain sampler on the CPU replaying
# the card's trajectory (f32, sum order only) within WN_VAR_KS_ATOL.
WN_VARIANTS = ("1D", "2D", "Resize", "NearestNeighbor")
WN_VAR_SERVE = "Resize"
WN_VAR_STEPS = 2
WN_VAR_FRAMES = 3
WN_VAR_UP_RTOL = 1e-4
WN_VAR_KS_ATOL = 1e-4
WN_VAR_GIN, WN_VAR_SPEAKERS = 16, 4
WN_VAR_PRE_ROWS = 16


def with_wavenet(cfg, **wn):
    return cfg.replace(wavenet=dataclasses.replace(cfg.wavenet, **wn))


def wavenet_variant_tree(cfg, wparams, seed, global_conditioning=False):
    """`init_wavenet` weights for `cfg` (seeded) as a flax tree, with the r5
    EMA checkpoint's leaves where path and shape agree. Returns (tree,
    grafted, fresh)."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import convert
    tree = convert.wavenet_to_flax(convert.init_wavenet(
        cfg, torch.Generator().manual_seed(seed), "cpu",
        global_conditioning=global_conditioning))
    r5 = _leaves(wparams)
    grafted = 0
    mine = _leaves(tree)
    for path, leaf in mine.items():
        if path in r5 and np.shape(r5[path]) == leaf.shape:
            convert.tree_set(tree, path, np.asarray(r5[path], np.float32))
            grafted += 1
    return tree, grafted, len(mine) - grafted


def stack_steps(trainer, state, batches, gen):
    """Train steps, the last under torch.profiler (device activity only):
    (state, losses, host ms a step of the unprofiled ones, the wrappers'
    launches (5a, 5b) over all of them, and over the last the C side's
    kernel launches and the trace's stack kernels by name, each (forward,
    backward)). PyTorch's own kernels (at::native's reduce_kernel among
    them) are told apart by their namespace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    wtk.fwd_launches = wtk.bwd_launches = 0
    losses = []
    torch.cuda.synchronize()
    ts = time.time()
    for b in batches[:-1]:
        state, m = trainer.train_step(state, b, gen)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    ms = 1e3 * (time.time() - ts) / max(1, len(batches) - 1)
    n0 = (wtk.fwd_kernel_launches, wtk.bwd_kernel_launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = trainer.train_step(state, batches[-1], gen)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    ours = lambda n, kinds: any(k in n for k in kinds) and not any(
        lib in n for lib in ("at::", "cudnn", "cutlass", "cublas"))
    evs = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = tuple(sum(ours(n, kinds) for n in evs)
                 for kinds in (STACK_KINDS[:2], STACK_KINDS[2:]))
    counted = (wtk.fwd_kernel_launches - n0[0],
               wtk.bwd_kernel_launches - n0[1])
    return (state, losses, ms, (wtk.fwd_launches, wtk.bwd_launches),
            counted, seen)


def hold_variant_samplers(runs, W):
    """Phase 29's sampler runs [(name, config, WaveNetSynthesizer, wavs,
    launches)], whose kernel weights are one set (the variants differ in
    the upsample and the gin weights, which the kernel drops; checked),
    each repeated by the kernel over its first W samples, timed, and held
    by phase 5's gate (`check_head`'s for the Gaussian head) against the
    plain version replaying the kernel's trajectory: the replays, bf16 and
    f32, run once over all the runs' rows (a Python loop of launches a
    step, so its time hardly depends on the rows). Returns the `kernels`
    entries; each plain_ms is that bf16 replay's."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    _, cfg, ws0, _, _ = runs[0]
    dts = dict(cache_dtype=ws0.cache_dtype, weight_dtype=ws0.weight_dtype)
    sp, kw0 = ws0.sampler_params, ws0.sampler_kernel
    c_all, n_all, y_all, times = [], [], [], []
    for name, cfg_v, ws, wavs, _ in runs:
        assert torch.equal(ws.sampler_kernel.slices, kw0.slices), name
        c_w = ws.intermediates["c_up"][:, :W].contiguous()
        n_w = ws.intermediates["noise"][:, :, :W].contiguous()
        run = lambda: wk.sample(ws.sampler_params, cfg_v, c_w, n_w,
                                kernel_weights=ws.sampler_kernel, **dts)
        y_k = run()
        assert np.array_equal(y_k.cpu().numpy(), np.stack(
            [w_[:W] for w_ in wavs])), f"{name}: not the synthesizer's"
        times.append(cuda_ms(run, 3))
        c_all.append(c_w)
        n_all.append(n_w)
        y_all.append(y_k)
    B = y_all[0].shape[0]
    c_all, n_all = torch.cat(c_all, 0), torch.cat(n_all, 1)
    y_all = torch.cat(y_all, 0)
    torch.cuda.synchronize()
    ts = time.time()
    y_r, _ = wk.teacher_forced_replay(sp, cfg, c_all, n_all, y_all, **dts)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - ts)
    y_r32, _ = wk.teacher_forced_replay(sp, cfg, c_all, n_all, y_all)
    bound_s, bound_by = sampler_bound_s(sp, cfg, B, W, True)
    print(f"the plain version replaying {len(runs)} runs' trajectories "
          f"at once ({len(runs) * B} rows x {W} samples): bf16 "
          f"{plain_ms:.3f} ms; each run's bound {1e3 * bound_s:.4f} ms "
          f"({bound_by})")
    entries = []
    for i, (name, _, _, _, n_launch) in enumerate(runs):
        rows = slice(i * B, (i + 1) * B)
        err = float((y_all[rows] - y_r[rows]).abs().max())
        err32 = float((y_all[rows] - y_r32[rows]).abs().max())
        print(f"wavenet_sampler_{name}_bf16: {B}x{W} samples, kernel "
              f"{times[i]:.3f} ms ({chain_us(times[i], W, cfg)}); max "
              f"|kernel - replay| {err:.3e} (the f32 replay's {err32:.3e})")
        assert err <= SAMPLER_REPLAY_ATOL["bfloat16"], (name, err)
        assert err <= 0.5 * err32, (name, err, err32)
        entries.append({
            "name": f"wavenet_sampler_{name}_bf16", "route": "cuda",
            "source": "tacotron2_tpu_torch/csrc/sampler.cu",
            "replaces": "tacotron2_tpu/ops/wavenet_kernel.py:180",
            "launches": n_launch, "max_abs_err": err, "ms": times[i],
            "plain_ms": plain_ms, "bound_ms": 1e3 * bound_s,
            "bound_by": bound_by, "library_ms": None})
    return entries


def wavenet_variants_phase(serve_in, gt, tparams, stats, wparams, seed):
    """Phase 29: the WaveNet variants on JAX's routes. Returns the
    `kernels` entries of the sampler kernel for each variant it
    samples."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch import cli, convert
    from tacotron2_tpu_torch.data.audio import save_wav
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from tacotron2_tpu_torch.synth.wavenet_synth import WaveNetSynthesizer
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    from tacotron2_tpu_torch.train.wavenet_train import \
        _export_speaker_embeddings
    cfg = r5_config()
    B, F, W = len(WN_ROWS), WN_CROP_FRAMES, SAMPLER_WINDOW
    t0 = phase(29, f"(v) the WaveNet variants: upsample {WN_VARIANTS}, "
               f"gin_channels {WN_VAR_GIN}, kernel_size 2, cin_channels -1;"
               f" B={B} crops of {F * 200} samples; preprocessing")
    dev = torch.device("cuda")
    pairs = r5_wavenet_rows(os.path.join(R5, "corpus"), WN_ROWS)
    rng = np.random.default_rng(seed + 29)
    batches = [wavenet_batch(pairs, [int(rng.integers(0, len(m) - F + 1))
                                     for _, m in pairs])
               for _ in range(WN_VAR_STEPS)]
    mels = [m[:WN_VAR_FRAMES] for m in gt]
    bf16 = ("wavenet.sampler_cache_dtype=bfloat16,"
            "wavenet.sampler_weight_dtype=bfloat16")

    def train(name, cfg_v, tree, batches_v, fused):
        tr = WaveNetTrainer(cfg_v)
        st = tr.init_state(model=convert.wavenet_from_flax(
            cfg_v, tree, dev, trainable=True))
        st, losses, ms, wrapped, counted, seen = stack_steps(
            tr, st, batches_v, torch.Generator().manual_seed(seed))
        route = "kernels 5a/5b" if fused else "the layer loop"
        print(f"{name}: {len(batches_v)} train steps on {route}, the "
              f"first {ms:.1f} ms (host clock), the last profiled; losses "
              + " ".join(f"{x:.4f}" for x in losses) + f"; 5a/5b launches "
              f"{wrapped}; the last step's kernel launches counted "
              f"{counted}, profiled {seen}")
        assert np.isfinite(losses).all(), losses
        assert counted == seen, (name, counted, seen)
        n = len(batches_v) if fused else 0
        assert wrapped == (n, n), (name, wrapped)
        assert (min(counted) > 0) == fused, (name, counted)
        return st

    def sample(name, cfg_v, tree):
        cfg_s = cfg_v.with_overrides(bf16)
        ws = WaveNetSynthesizer(cfg_s, tree, device="cuda", seed=seed,
                                keep_intermediates=True)
        assert ws.sampler_kernel is not None, name
        wk.launches = 0
        torch.cuda.synchronize()
        ts = time.time()
        wavs = ws.synthesize(mels)
        torch.cuda.synchronize()
        n_launch = wk.launches
        print(f"{name}: WaveNetSynthesizer on {len(mels)} mels of "
              f"{WN_VAR_FRAMES} frames through the bf16 sampler kernel, "
              f"{1e3 * (time.time() - ts):.1f} ms, launches {n_launch}")
        assert n_launch > 0 and all(
            len(w_) == WN_VAR_FRAMES * 200 and np.isfinite(w_).all()
            for w_ in wavs)
        runs.append((name, cfg_s, ws, wavs, n_launch))

    runs = []
    # ---- the upsample variants: upsample, training on 5a/5b, sampling
    for v in WN_VARIANTS:
        cfg_v = with_wavenet(cfg, upsample_type=v)
        tree, n_g, n_f = wavenet_variant_tree(cfg_v, wparams, seed)
        c = torch.as_tensor(batches[0]["c"])
        up_g = convert.wavenet_from_flax(cfg_v, tree, dev).upsample(
            c.to(dev)).cpu()
        up_c = convert.wavenet_from_flax(cfg_v, tree, "cpu").upsample(c)
        up_err = float((up_g - up_c).abs().max())
        scale = max(1.0, float(up_c.abs().max()))
        print(f"{v}: {n_g} leaves from r5, {n_f} fresh; upsample "
              f"{tuple(c.shape)} -> {tuple(up_g.shape)}, card against CPU "
              f"(f32) max |d| {up_err:.3e} (scale {scale:.3f})")
        assert up_g.shape == (B, F * 200, cfg.wavenet.cin_channels)
        assert up_err <= WN_VAR_UP_RTOL * scale, (v, up_err)
        train(v, cfg_v, tree, batches, fused=True)
        sample(v, cfg_v, tree)
        if v == WN_VAR_SERVE:
            serve_tree = tree

    # ---- one variant served through TextToWavProgram (kernels 1 and 2)
    cfg_r = with_wavenet(cfg, upsample_type=WN_VAR_SERVE)
    ids, lengths, refs = serve_in
    prog = TextToWavProgram(cfg_r, tparams, stats, serve_tree,
                            batch=len(ids), steps=MAX_STEPS, t_in=T_IN,
                            t_ref=T_REF, device="cuda", seed=seed)
    dk.rows_launches = wk.launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    samples, wav_len, mel, _, mel_len = prog(ids, lengths, refs, refs)
    torch.cuda.synchronize()
    serve_s = time.time() - ts
    launches = (dk.rows_launches, wk.launches)
    samples, wav_len = samples.cpu().numpy(), wav_len.cpu().numpy()
    mel_len = mel_len.cpu().numpy()
    print(f"{WN_VAR_SERVE} vocoder served through TextToWavProgram: "
          f"{len(ids)} texts in {serve_s:.3f} s, wav samples "
          f"{wav_len.tolist()}, launches (decode, sampler) {launches}")
    assert min(launches) > 0, launches
    assert np.isfinite(samples).all()
    assert (wav_len == mel_len * prog.hop).all() and wav_len.min() > 0

    # ---- global conditioning: 4 speakers, the layer loop, the export,
    # sampling through the kernel without the speaker (as in JAX)
    cfg_g = with_wavenet(cfg, gin_channels=WN_VAR_GIN,
                         use_speaker_embedding=True,
                         n_speakers=WN_VAR_SPEAKERS)
    tree_g, n_g, n_f = wavenet_variant_tree(cfg_g, wparams, seed,
                                            global_conditioning=True)
    gb = [dict(b, g=np.arange(B, dtype=np.int32) % WN_VAR_SPEAKERS)
          for b in batches]
    print(f"gin_channels {WN_VAR_GIN}, {WN_VAR_SPEAKERS} speakers: {n_g} "
          f"leaves from r5, {n_f} fresh")
    st = train("gin", cfg_g, tree_g, gb, fused=False)
    with tempfile.TemporaryDirectory() as tmp:
        _export_speaker_embeddings(cfg_g, st, tmp)
        d = os.path.join(tmp, "speaker_embeddings")
        rows = open(os.path.join(d, "embeddings.tsv")).read().splitlines()
        meta = open(os.path.join(d, "metadata.tsv")).read().split()
        print(f"gin: speaker export {len(rows)} rows of "
              f"{len(rows[0].split())} values, metadata {meta}")
        assert len(rows) == WN_VAR_SPEAKERS and meta == [
            f"speaker_{i}" for i in range(WN_VAR_SPEAKERS)]
        assert all(len(r.split("\t")) == WN_VAR_GIN for r in rows)
    del st
    # the grafted weights: after 2 steps the EMA carries Adam's first
    # step from r5's trained state (the loss in the hundreds), where the
    # bf16 and f32 replays no longer part as phase 5's gate needs
    sample("gin", cfg_g, tree_g)
    entries = hold_variant_samplers(runs, W)

    # ---- kernel_size 2: the layer loop, then the plain sampler on the card
    cfg_k = with_wavenet(cfg, kernel_size=2)
    tree_k, n_g, n_f = wavenet_variant_tree(cfg_k, wparams, seed)
    print(f"kernel_size 2: {n_g} leaves from r5, {n_f} fresh")
    train("kernel_size 2", cfg_k, tree_k, batches, fused=False)
    ws = WaveNetSynthesizer(cfg_k, tree_k, device="cuda", seed=seed,
                            keep_intermediates=True)
    assert ws.sampler_kernel is None
    wk.launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    wavs = ws.synthesize(mels)
    torch.cuda.synchronize()
    ks_ms = 1e3 * (time.time() - ts)
    y_card = torch.as_tensor(np.stack([w_[:W] for w_ in wavs]))
    c_w = ws.intermediates["c_up"][:, :W].cpu()
    n_w = ws.intermediates["noise"][:, :, :W].cpu()
    y_cpu, _ = wk.teacher_forced_replay(to_cpu(ws.sampler_params), cfg_k,
                                        c_w, n_w, y_card)
    ks_err = float((y_card - y_cpu).abs().max())
    print(f"kernel_size 2: the plain sampler on the card, {len(wavs)}x"
          f"{len(wavs[0])} samples in {ks_ms:.1f} ms (sampler kernel "
          f"launches {wk.launches}); the CPU's replay of its first {W}: "
          f"max |d| {ks_err:.3e}")
    assert wk.launches == 0 and np.isfinite(y_card.numpy()).all()
    assert ks_err <= WN_VAR_KS_ATOL, ks_err

    # ---- no local conditioning: the layer loop; the synthesizer raises
    cfg_u = with_wavenet(cfg, cin_channels=-1)
    tree_u, n_g, n_f = wavenet_variant_tree(cfg_u, wparams, seed)
    print(f"cin_channels -1: {n_g} leaves from r5, {n_f} fresh")
    train("cin_channels -1", cfg_u, tree_u, batches, fused=False)
    try:
        WaveNetSynthesizer(cfg_u, tree_u, device="cuda").synthesize(mels)
    except ValueError as e:
        print(f"cin_channels -1: WaveNetSynthesizer raises ValueError: {e}")
    else:
        raise AssertionError("an unconditioned WaveNet vocoded mels")

    # ---- the preprocessing commands on 16 r5 wavs, then train --model
    # WaveNet on the map.txt they write
    hp = ("tacotron.compute_dtype=bfloat16,wavenet.compute_dtype=bfloat16,"
          "wavenet.use_fused_train_stack=true,audio.trim_silence=false,"
          f"train.max_time_steps={F * 200}")
    texts = corpus_texts()
    with tempfile.TemporaryDirectory() as tmp:
        lj = os.path.join(tmp, "lj")
        os.makedirs(os.path.join(lj, "wavs"))
        with open(os.path.join(lj, "metadata.csv"), "w",
                  encoding="utf-8") as f:
            for i in range(WN_VAR_PRE_ROWS):
                save_wav(np.load(os.path.join(R5, "corpus", "audio",
                                              f"audio-{i}.npy")),
                         os.path.join(lj, "wavs", f"r5-{i:02d}.wav"),
                         cfg.audio.sample_rate)
                f.write(f"r5-{i:02d}|{texts[i]}|{texts[i]}\n")
        ts = time.time()
        meta = cli.main(["--hparams", hp, "create-metadata", "--in-dir", lj,
                         "--out-path", os.path.join(tmp, "meta.txt")])
        train_txt = cli.main(["--hparams", hp, "preprocess", "--dataset",
                              "lj", "--in-dir", lj, "--metadata", meta,
                              "--out-dir", os.path.join(tmp, "taco"),
                              "--write-audio", "--n-jobs", "4"])
        map_txt = cli.main(["--hparams", hp, "wavenet-preprocess",
                            "--in-dir", os.path.join(lj, "wavs"),
                            "--out-dir", os.path.join(tmp, "wn"),
                            "--serial"])
        pre_s = time.time() - ts
        rows_t = open(train_txt, encoding="utf-8").read().splitlines()
        rows_m = open(map_txt, encoding="utf-8").read().splitlines()
        for r in rows_m:
            a, m = np.load(r.split("|")[0]), np.load(r.split("|")[1])
            assert m.shape[1] == cfg.audio.num_mels and \
                len(a) == m.shape[0] * 200 and np.isfinite(m).all(), r
        print(f"create-metadata, preprocess (4 spawned workers) and "
              f"wavenet-preprocess (serial) of {WN_VAR_PRE_ROWS} r5 wavs: "
              f"{pre_s:.3f} s; train.txt "
              f"{len(rows_t)} rows, map.txt {len(rows_m)} rows")
        assert len(rows_t) == len(rows_m) == WN_VAR_PRE_ROWS
        wtk.fwd_launches = 0
        ckpt_dir = cli.main(["--hparams", hp + ",wavenet.upsample_type=1D",
                             "train", "--model", "WaveNet", "--input-path",
                             map_txt, "--base-dir", os.path.join(tmp, "run"),
                             "--train-steps", "3", "--batch-size", str(B),
                             "--eval-interval", "0"])
        saved = sorted(os.listdir(ckpt_dir))
        print(f"cli train --model WaveNet (1D upsample) on that map.txt: "
              f"checkpoints {saved}, stack forward launches "
              f"{wtk.fwd_launches}")
        assert saved == ["ckpt-3.msgpack"] and wtk.fwd_launches == 3
    done(29, t0)
    return entries


# phase 30: data parallelism (tacotron2_tpu_torch/parallel/dist.py). (a)
# An nccl group of one rank in this process: the data-parallel wrappers of
# the Tacotron and WaveNet steps against the plain steps, one step each.
# (b) Two gloo ranks spawned on this one card (nccl refuses two ranks on
# one device), each loading the r5 checkpoints: Tacotron steps at the r5
# width on DP_TACO_ROWS train rows (each rank its half, padded to its own
# longest, the group padding them to the global batch's) in bf16 and in
# f32 compute, held to the one-process step on the global batch on the
# card; WaveNet steps from init_wavenet on phase 19's crops at dropout 0
# (the ranks' stack dropout seeds are seed + rank, as JAX's are, so only
# there do the two agree), held likewise; the serving program's sharded
# call over the 8 held-out texts and the sharded sampler on phase 5's
# [8, 512] window, each rank's rows held to the one-process program and
# sampler on those rows with that rank's seed. Gates: f32 DP_F32_RTOL on
# every loss term and grad_norm (the same function, the group's sums in
# another order); bf16 DP_BF16_RTOL of the step's loss on every term
# (phase 16's whole-step gate: an f32 sum order may move an isolated bf16
# rounding) and DP_BF16_NORM_RTOL on grad_norm; the two ranks'
# parameters bit for bit alike after the steps; the serving outputs and
# the samples of the same kernels on the same rows and numbers equal,
# lengths exactly, each kernel's launches on a rank those of the
# one-process program on its rows (kernel 1 launches the decode's chain of
# blocks, kernel 2 once). The ranks share one card, so no time of this
# phase is a scaling figure.
DP_WORLD = 2
DP_TACO_ROWS, DP_STEPS = 16, 2
DP_TIMEOUT_S = 600
DP_F32_RTOL = 1e-5
DP_BF16_RTOL = 1e-3
DP_BF16_NORM_RTOL = 1e-2
DP_SERVE_ATOL = 1e-6
DP_PROG_SEED = 30
DP_TERMS = ("loss", "before_loss", "after_loss", "stop_token_loss",
            "regularization_loss", "style_emb_loss_emt",
            "style_emb_loss_spk", "style_emb_orthog_loss")


def dp_taco_cfgs():
    """{name: config} of phase 30's Tacotron runs: the r5 training config
    (bf16 compute, bf16 kernels 4a/4b) and its f32 version."""
    cfg = train_config()
    return {"taco_bf16": cfg,
            "taco_f32": with_tacotron(cfg, compute_dtype="float32",
                                      fused_train_dtype="float32")}


def dp_wavenet_cfg():
    cfg = r5_config()
    return cfg.replace(wavenet=dataclasses.replace(cfg.wavenet, dropout=0.0))


def dp_taco_batches(cfg):
    """(the global batch of the first DP_TACO_ROWS train rows, padded to
    its longest, [each rank's rows padded to its own longest])."""
    from tacotron2_tpu_torch.eval.convergence import batch_from_rows
    texts = corpus_texts()
    mel_dir = os.path.join(R5, "corpus", "mels")
    rows = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
            for i, t in enumerate(texts[:DP_TACO_ROWS])]
    n = DP_TACO_ROWS // DP_WORLD
    return (batch_from_rows(rows, mel_dir, cfg),
            [batch_from_rows(rows[r * n:(r + 1) * n], mel_dir, cfg)
             for r in range(DP_WORLD)])


def dp_wavenet_batches(seed):
    """(phase 19's crops of rows 0-15 as one global batch, [each rank's
    rows])."""
    import numpy as np
    pairs = r5_wavenet_rows(os.path.join(R5, "corpus"), WN_ROWS)
    rng = np.random.default_rng(seed + 30)
    b = wavenet_batch(pairs, [int(rng.integers(0, len(m) - WN_CROP_FRAMES
                                               + 1)) for _, m in pairs])
    n = len(WN_ROWS) // DP_WORLD
    return b, [{k: v[r * n:(r + 1) * n] for k, v in b.items()}
               for r in range(DP_WORLD)]


def params_digest(model):
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_taco_run(cfg, tparams, stats, batch, seed, dp, steps=DP_STEPS):
    """`steps` Tacotron steps from the r5 weights on `batch`, through
    `TacotronTrainer(dp=dp)` (the plain trainer for None), the generator
    of step i seeded seed + i: each step's scalars, kernel 4a's and 4b's
    launches, the seconds and the parameters' digest."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.convert import load_tacotron
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    from tacotron2_tpu_torch.train.tacotron_step import TacotronTrainer
    dev = dp.device if dp is not None else torch.device("cuda")
    trainer = TacotronTrainer(cfg, device=dev, dp=dp)
    state = trainer.init_state(
        model=load_tacotron(Tacotron(cfg), tparams, stats).to(dev))
    metrics = []
    tk.train_launches = tk.bwd_launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    for i in range(steps):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        state, m = trainer.train_step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()
                        if np.ndim(v) == 0})
    torch.cuda.synchronize()
    return dict(metrics=metrics, seconds=time.time() - ts,
                launches=(tk.train_launches, tk.bwd_launches),
                digest=params_digest(state.model))


def dp_wavenet_run(batch, seed, dp, steps=DP_STEPS):
    """`steps` WaveNet steps at dropout 0 through `WaveNetTrainer(dp=dp)`
    from `init_wavenet`'s draw of `seed` (as phase 19's run: from the r5
    EMA weights Adam's first step throws the Gaussian loss to the
    hundreds, where the second step's loss magnifies every difference):
    scalars, kernel 5a's and 5b's launches, seconds, digest."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    cfg = dp_wavenet_cfg()
    dev = dp.device if dp is not None else torch.device("cuda")
    trainer = WaveNetTrainer(cfg, device=dev, dp=dp)
    state = trainer.init_state(torch.Generator().manual_seed(seed), batch)
    gen = torch.Generator().manual_seed(seed + 1)
    metrics = []
    wtk.fwd_launches = wtk.bwd_launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    for _ in range(steps):
        state, m = trainer.train_step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()
                        if np.ndim(v) == 0})
    torch.cuda.synchronize()
    return dict(metrics=metrics, seconds=time.time() - ts,
                launches=(wtk.fwd_launches, wtk.bwd_launches),
                digest=params_digest(state.model))


def dp_program(tparams, stats, wparams, batch, seed, device):
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    return TextToWavProgram(r5_config(), tparams, stats, wparams,
                            batch=batch, steps=MAX_STEPS, t_in=T_IN,
                            t_ref=T_REF, device=device, seed=seed)


def dp_rank(rank, world, port, spec_path, out_dir):
    """One rank of phase 30 (b), started by torch.multiprocessing: the
    group from torchrun's env with gloo on the shared card, the r5
    checkpoints, then each run with its kernel counts set to 0 just before
    and read just after; its results pickled to <out_dir>/rank<r>.pkl."""
    import pickle
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch
    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp = dist.maybe_initialize_distributed(backend="gloo", device="cuda:0",
                                           timeout_s=DP_TIMEOUT_S)
    assert (dp.rank, dp.world, str(dp.device)) == (rank, world, "cuda:0")
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    tparams, stats, wparams = load_checkpoints(
        os.path.join(R5, "taco_ckpt.msgpack"),
        os.path.join(R5, "wn_ckpt.msgpack"))
    seed, out = spec["seed"], {}
    try:
        for name, cfg in dp_taco_cfgs().items():
            out[name] = dp_taco_run(cfg, tparams, stats,
                                    spec[name][rank], seed, dp)
        out["wavenet"] = dp_wavenet_run(spec["wavenet"][rank], seed, dp)
        B = len(spec["serve"][0])
        prog = dp_program(tparams, stats, wparams, B // world,
                          DP_PROG_SEED, dp.device)
        dk.rows_launches = wk.launches = 0
        torch.cuda.synchronize()
        ts = time.time()
        served = prog.sharded_call(dp, *spec["serve"])
        torch.cuda.synchronize()
        out["serve"] = dict(
            seconds=time.time() - ts,
            launches=(dk.rows_launches, wk.launches),
            outputs=[x.cpu().numpy() for x in served])
        c_w = torch.as_tensor(spec["c_w"], device=dp.device)
        wk.launches = 0
        torch.cuda.synchronize()
        ts = time.time()
        s = wk.sharded_sample(prog.sampler_params, r5_config(), c_w,
                              seed, dp, kernel_weights=prog.sampler_kernel)
        torch.cuda.synchronize()
        out["sample"] = dict(seconds=time.time() - ts, launches=wk.launches,
                             samples=s.cpu().numpy())
    finally:
        dist.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def hold_dp(name, got, want, rtol, norm_rtol, scale="term"):
    """Each step's loss terms within rtol of the one-process step's: of
    each term's own value (scale "term", with an absolute floor of rtol ·
    1e-3 for the terms near 0), or of the step's loss (scale "loss",
    phase 16's whole-step gate: a bf16 rounding that an f32 sum order
    moves shifts a small term such as the stop loss by more than rtol of
    itself); grad_norm within norm_rtol of itself. Returns the largest
    relative differences, each of its own term."""
    worst = {}
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in [t for t in DP_TERMS if t in w] + ["grad_norm"]:
            d = abs(g[k] - w[k])
            if k == "grad_norm":
                bound = norm_rtol * abs(w[k])
            elif scale == "loss":
                bound = rtol * abs(w["loss"])
            else:
                bound = rtol * abs(w[k]) + rtol * 1e-3
            assert d <= bound, (name, i, k, g[k], w[k])
            worst[k] = max(worst.get(k, 0.0), d / max(abs(w[k]), 1e-12))
    print(f"{name}: largest relative difference from the one-process "
          f"step over {len(want['metrics'])} step(s): " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items()))
    return worst


def dp_phase(tparams, stats, wparams, serve_in, c_w, seed, smi):
    """Phase 30: data parallelism, (a) nccl at world 1 in this process,
    (b) two gloo ranks on the card. Returns {kernels entry name: [its
    launches on rank 0, on rank 1]} of the ranks' runs."""
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from tacotron2_tpu_torch.models.wavenet.distributions import draw_noise
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.parallel import dist
    t0 = phase(30, f"(w) data parallelism: nccl at world 1; {DP_WORLD} gloo "
               f"ranks on one card: Tacotron ({DP_TACO_ROWS} rows, bf16 and "
               f"f32), WaveNet ({len(WN_ROWS)} crops), the served program "
               f"and the sampler, sharded")
    print(f"{smi}; the ranks share one card: no time of this phase is a "
          f"scaling figure")
    taco = {name: dp_taco_batches(cfg) for name, cfg in dp_taco_cfgs().items()}
    wn_global, wn_ranks = dp_wavenet_batches(seed)

    # ---- (a) an nccl group of one rank in this process
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dp1 = dist.maybe_initialize_distributed()
        assert dp1 is not None and dp1.world == 1
        assert torch.distributed.get_backend() == "nccl"
        try:
            dist.rank_device("cuda:0", "nccl", 0, 2)
            raise AssertionError("nccl was given two ranks on one card")
        except ValueError as e:
            print(f"two ranks on one card under nccl: ValueError: {e}")
        cfg = dp_taco_cfgs()["taco_bf16"]
        glob = taco["taco_bf16"][0]
        got = dp_taco_run(cfg, tparams, stats, glob, seed, dp1, steps=1)
        want = dp_taco_run(cfg, tparams, stats, glob, seed, None, steps=1)
        hold_dp("(a) Tacotron bf16, nccl world 1", got, want, DP_BF16_RTOL,
                DP_BF16_NORM_RTOL, scale="loss")
        assert got["launches"] == want["launches"] == (1, 1), got
        got = dp_wavenet_run(wn_global, seed, dp1, steps=1)
        want = dp_wavenet_run(wn_global, seed, None, steps=1)
        hold_dp("(a) WaveNet bf16, nccl world 1", got, want, DP_BF16_RTOL,
                DP_BF16_NORM_RTOL, scale="loss")
        assert got["launches"] == want["launches"] == (1, 1), got
    finally:
        dist.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # ---- (b) two gloo ranks sharing the card; the one-process references
    # run here meanwhile
    tmp = tempfile.mkdtemp(prefix="dp30_")
    spec = dict(seed=seed, wavenet=wn_ranks, serve=serve_in, c_w=c_w,
                **{name: ranks for name, (_, ranks) in taco.items()})
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    ts = time.time()
    ctx = mp.spawn(dp_rank, args=(DP_WORLD, free_port(), spec_path, tmp),
                   nprocs=DP_WORLD, join=False)
    cfg5 = r5_config()
    n = len(serve_in[0]) // DP_WORLD
    try:
        want = {name: dp_taco_run(cfg, tparams, stats, taco[name][0], seed,
                                  None)
                for name, cfg in dp_taco_cfgs().items()}
        want["wavenet"] = dp_wavenet_run(wn_global, seed, None)
        c_dev = torch.as_tensor(c_w, device="cuda")
        serve_ref, sample_ref, ref_launches = [], [], []
        for r in range(DP_WORLD):
            rows = slice(r * n, (r + 1) * n)
            # the program's first call seeds seed + 1: shard r of the
            # sharded call seeds DP_PROG_SEED + world + r
            prog = dp_program(tparams, stats, wparams, n,
                              DP_PROG_SEED + DP_WORLD + r - 1, "cuda")
            dk.rows_launches = wk.launches = 0
            serve_ref.append([x.cpu().numpy() for x in
                              prog(*(x[rows] for x in serve_in))])
            ref_launches.append((dk.rows_launches, wk.launches))
            gen = torch.Generator(device="cuda").manual_seed(
                seed + r * wk.SHARD_SEED_STRIDE)
            noise = draw_noise(cfg5, n, c_dev.shape[1], gen, "cuda")
            sample_ref.append(wk.sample(
                prog.sampler_params, cfg5, c_dev[rows].contiguous(), noise,
                kernel_weights=prog.sampler_kernel).cpu().numpy())
            del prog
        while not ctx.join(timeout=max(1.0, ts + DP_TIMEOUT_S - time.time())):
            if time.time() >= ts + DP_TIMEOUT_S:
                raise TimeoutError(f"phase 30's ranks still run after "
                                   f"{DP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks_s = time.time() - ts
    res = []
    for r in range(DP_WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"ranks and the one-process references: {ranks_s:.3f} s")

    counts = {}
    names = dict(taco_bf16=("tacotron_teacher_forced_train", "tacotron_bptt"),
                 taco_f32=("tacotron_teacher_forced_train_f32",
                           "tacotron_bptt_f32"),
                 wavenet=("wavenet_stack_fwd", "wavenet_stack_bwd"))
    for name, rtol, nrtol, scale in (
            ("taco_bf16", DP_BF16_RTOL, DP_BF16_NORM_RTOL, "loss"),
            ("taco_f32", DP_F32_RTOL, DP_F32_RTOL, "term"),
            ("wavenet", DP_BF16_RTOL, DP_BF16_NORM_RTOL, "loss")):
        r0, r1 = res[0][name], res[1][name]
        assert r0["metrics"] == r1["metrics"], name
        assert r0["digest"] == r1["digest"], f"{name}: the ranks drifted"
        hold_dp(f"(b) {name}, {DP_WORLD} gloo ranks", r0, want[name], rtol,
                nrtol, scale)
        per = [r[name]["launches"] for r in res]
        print(f"(b) {name}: {DP_STEPS} steps; launches per rank "
              f"{names[name][0]}/{names[name][1]} {per}; seconds per rank "
              + ", ".join(f"{r[name]['seconds']:.3f}" for r in res)
              + f" (one process, the global batch: "
                f"{want[name]['seconds']:.3f})")
        assert all(c == (DP_STEPS, DP_STEPS) for c in per), per
        for j, k in enumerate(names[name]):
            counts[k] = [c[j] for c in per]

    served = [r["serve"]["outputs"] for r in res]
    for out in served[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(out, served[0]))
    samples, wav_len, mel, _, mel_len = served[0]
    for r in range(DP_WORLD):
        rows = slice(r * n, (r + 1) * n)
        s_r, wl_r, m_r, _, ml_r = serve_ref[r]
        assert np.array_equal(wav_len[rows], wl_r), (r, wav_len, wl_r)
        assert np.array_equal(mel_len[rows], ml_r), (r, mel_len, ml_r)
        dm = float(np.abs(mel[rows] - m_r).max())
        ds = float(np.abs(samples[rows] - s_r).max())
        dw = float(np.abs(res[0]["sample"]["samples"][rows]
                          - sample_ref[r]).max())
        print(f"(b) rank {r}'s rows against the one-process program seeded "
              f"{DP_PROG_SEED + DP_WORLD + r} and the sampler seeded "
              f"{seed + r * wk.SHARD_SEED_STRIDE}: max |mel difference| "
              f"{dm:.3e}, |sample difference| {ds:.3e}, sharded sampler "
              f"{dw:.3e}")
        assert max(dm, ds, dw) <= DP_SERVE_ATOL, (r, dm, ds, dw)
    per = [r["serve"]["launches"] for r in res]
    per_s = [r["sample"]["launches"] for r in res]
    print(f"(b) sharded_call of {len(serve_in[0])} texts: launches per rank "
          f"(kernel 1, kernel 2) {per} (the one-process program on each "
          f"rank's rows: {ref_launches}); seconds per rank "
          + ", ".join(f"{r['serve']['seconds']:.3f}" for r in res))
    print(f"(b) sharded_sample [{c_w.shape[0]}, {c_w.shape[1]}]: launches "
          f"per rank {per_s}; seconds per rank "
          + ", ".join(f"{r['sample']['seconds']:.3f}" for r in res))
    # kernel 1 launches the decode's chain of blocks, kernel 2 once
    assert per == ref_launches and all(c[1] == 1 for c in per), per
    assert per_s == [1] * DP_WORLD, per_s
    counts["tacotron_decoder"] = [c[0] for c in per]
    counts["wavenet_sampler_bf16"] = [c[1] + s for c, s in zip(per, per_s)]
    done(30, t0)
    return counts


# phase 31: tensor parallelism and the long tail. (a) a (data 2 × model 2)
# gloo group of four processes sharing the card, each from the r5
# checkpoints: the sharded WaveNet's eval forward (the channel-split layer
# loop, f32) on short crops of phase 19's rows, two bf16 and two f32 TP
# train steps (kernels 5a/5b on weights gathered over 'model') and a
# Tacotron step under the 2-D group (kernels 4a/4b), each held against the
# one-process run this process makes meanwhile; (b) Griffin-Lim's bf16
# mode on both routes against its plain version, timed beside the f32
# kernel and cuFFT; (c) griffin_lim_tf on the card against the CPU; (d)
# the native data-IO runtime built and bit-equal to np.load; (e) `cli live
# --pipeline` over two stdin lines.
TP_DP, TP_MP = 2, 2
TP_WN_FRAMES = 10                # 2,000 samples a crop
TP_TIMEOUT_S = 300
TP_FWD_RTOL = 1e-4               # of max(1, |y|): f32 in another sum order
TP_STEPS = 2
GL_BF16_FRAMES = 321
# bf16 Griffin-Lim, kernel vs the route's plain version (both round to bf16
# at the same points; the f32 transforms and sums differ in order). On the
# CPU from a random-phase start (a chirp at n_fft 2,048; noise and tones at
# 512 and 1,024), two f32 FFTs of the same rounded operands differ by at
# most 1.8e-7 of the peak at 0 iterations and, at 1, by a median |diff| of
# 9.6e-7 of the median |sample| (a rare bf16 rounding that flips between
# the two can move a near-zero bin's phase, so the median, not the sum);
# leaving out the analysis' rounding moves that median by 2.8e-4 to 2.2e-3
GL_BF16_ITER0_RTOL = 2e-5        # max |kernel - plain| of the peak, iters 0
GL_BF16_ITER1_MED = 2e-5         # median |kernel - plain| / median |plain|
GL_BF16_APART = 10               # bf16 vs the f32 kernel: > this x the gates
GL_BF16_F32_DRIFT = 0.10         # bf16 vs the f32 kernel (JAX's own bound)
# griffin_lim_tf, of the peak. Card vs CPU, both the same f32 function in
# another sum order: read 2.8e-4 / 1.0e-4 (default / paper) at 2
# iterations and 1.27e-3 / 4.69e-3 at 60, where iterating amplifies f32
# sum-order noise in the phase of near-zero bins (the CPU itself sits
# 8.8e-4 / 4.4e-3 from the TF fixture at 60); gates about 2x above the
# larger reading. Card vs the TF fixture: the fixture's own gates
# (tests/test_reference_parity.py:112, :130)
GL_TF_CPU_RTOL = {2: 1e-3, 60: 1e-2}
GL_TF_FIXTURE_RTOL = {2: 2e-3, 60: 0.05}
LIVE_STEPS = 160


def tp_cfgs():
    """{name: config} of phase 31's WaveNet runs: phase 30's (bf16 stack,
    dropout 0) and its f32 version."""
    cfg = dp_wavenet_cfg()
    return {"wn_bf16": cfg, "wn_f32": cfg.replace(wavenet=dataclasses.replace(
        cfg.wavenet, compute_dtype="float32"))}


def tp_wavenet_batches(seed):
    """(TP_WN_FRAMES-frame crops of phase 19's 16 rows as one global
    batch, [each data shard's rows])."""
    import numpy as np
    pairs = r5_wavenet_rows(os.path.join(R5, "corpus"), WN_ROWS)
    rng = np.random.default_rng(seed + 31)
    b = wavenet_batch(pairs, [int(rng.integers(0, len(m) - TP_WN_FRAMES + 1))
                              for _, m in pairs], frames=TP_WN_FRAMES)
    n = len(WN_ROWS) // TP_DP
    return b, [{k: v[d * n:(d + 1) * n] for k, v in b.items()}
               for d in range(TP_DP)]


def tp_forward(wparams, batch, dp):
    """The r5 EMA WaveNet's f32 eval forward of `batch` (sharded over
    'model' under a 2-D `dp`: the channel-split layer loop)."""
    import torch
    from tacotron2_tpu_torch.convert import wavenet_from_flax
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    cfg = dp_wavenet_cfg()
    dev = dp.device if dp is not None else torch.device("cuda")
    state = WaveNetTrainer(cfg, device=dev, dp=dp).init_state(
        model=wavenet_from_flax(cfg, wparams, dev, trainable=True))
    x = torch.as_tensor(batch["x"], device=dev)
    c = torch.as_tensor(batch["c"], device=dev)
    torch.cuda.synchronize()
    ts = time.time()
    y, _ = state.model(x, c)
    torch.cuda.synchronize()
    return dict(y=y.cpu().numpy(), seconds=time.time() - ts)


def tp_wavenet_run(cfg, batch, seed, dp, steps=TP_STEPS):
    """`dp_wavenet_run` at `cfg` under a (data × model) group (or none):
    the state is sharded at init, and gathered whole for the digest."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.parallel import partition
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer
    dev = dp.device if dp is not None else torch.device("cuda")
    trainer = WaveNetTrainer(cfg, device=dev, dp=dp)
    state = trainer.init_state(torch.Generator().manual_seed(seed), batch)
    gen = torch.Generator().manual_seed(seed + 1)
    metrics = []
    wtk.fwd_launches = wtk.bwd_launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    for _ in range(steps):
        state, m = trainer.train_step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()
                        if np.ndim(v) == 0})
    torch.cuda.synchronize()
    seconds = time.time() - ts
    launches = (wtk.fwd_launches, wtk.bwd_launches)
    whole = partition.gather_wavenet_state(state)
    return dict(metrics=metrics, seconds=seconds, launches=launches,
                digest=params_digest(whole.model))


def tp_rank(rank, world, port, spec_path, out_dir):
    """One process of phase 31 (a), started by torch.multiprocessing: the
    (data × model) group from torchrun's env with gloo on the shared card,
    the r5 checkpoints, then each run with its kernel counts set to 0 just
    before and read just after; results pickled to <out_dir>/rank<r>.pkl."""
    import pickle
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch
    from tacotron2_tpu_torch.config import MeshConfig
    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp = dist.maybe_initialize_distributed(
        backend="gloo", device="cuda:0",
        mesh=MeshConfig(model_parallelism=TP_MP), timeout_s=TP_TIMEOUT_S)
    assert (dp.rank, dp.model_rank) == divmod(rank, TP_MP), dp
    assert (dp.world, dp.model_world) == (TP_DP, TP_MP), dp
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    tparams, stats, wparams = load_checkpoints(
        os.path.join(R5, "taco_ckpt.msgpack"),
        os.path.join(R5, "wn_ckpt.msgpack"))
    seed, out, d = spec["seed"], {}, dp.rank
    try:
        out["forward"] = tp_forward(wparams, spec["wn"][d], dp)
        for name, cfg in tp_cfgs().items():
            out[name] = tp_wavenet_run(cfg, spec["wn"][d], seed, dp)
        out["taco"] = dp_taco_run(dp_taco_cfgs()["taco_bf16"], tparams,
                                  stats, spec["taco"][d], seed, dp, steps=1)
    finally:
        dist.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def tp_group_phase(tparams, stats, wparams, seed):
    """Phase 31 (a). Returns {kernels entry name: [its launches on each
    process]}."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp
    world = TP_DP * TP_MP
    wn_global, wn_shards = tp_wavenet_batches(seed)
    taco_global, taco_shards = dp_taco_batches(dp_taco_cfgs()["taco_bf16"])
    tmp = tempfile.mkdtemp(prefix="tp31_")
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(dict(seed=seed, wn=wn_shards, taco=taco_shards), f)
    ts = time.time()
    ctx = mp.spawn(tp_rank, args=(world, free_port(), spec_path, tmp),
                   nprocs=world, join=False)
    try:
        want = {"forward": tp_forward(wparams, wn_global, None)}
        for name, cfg in tp_cfgs().items():
            want[name] = tp_wavenet_run(cfg, wn_global, seed, None)
        want["taco"] = dp_taco_run(dp_taco_cfgs()["taco_bf16"], tparams,
                                   stats, taco_global, seed, None, steps=1)
        while not ctx.join(timeout=max(1.0, ts + TP_TIMEOUT_S - time.time())):
            if time.time() >= ts + TP_TIMEOUT_S:
                raise TimeoutError(f"phase 31's processes still run after "
                                   f"{TP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    print(f"(a) {world} processes and the one-process references: "
          f"{time.time() - ts:.3f} s")
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    shutil.rmtree(tmp, ignore_errors=True)

    y = np.concatenate([res[d * TP_MP]["forward"]["y"] for d in range(TP_DP)])
    for r in range(world):
        mate = res[(r // TP_MP) * TP_MP]["forward"]["y"]
        assert np.array_equal(res[r]["forward"]["y"], mate), r
    yw = want["forward"]["y"]
    err = float(np.abs(y - yw).max())
    scale = max(1.0, float(np.abs(yw).max()))
    print(f"(a) sharded eval forward (channel-split layer loop, f32) of "
          f"{yw.shape[0]} crops of {yw.shape[1]} samples: max |sharded - "
          f"one process| {err:.3e} (outputs up to {scale:.3f}); seconds "
          f"per process " + ", ".join(f"{x['forward']['seconds']:.3f}"
                                      for x in res)
          + f" (one process {want['forward']['seconds']:.3f})")
    assert err <= TP_FWD_RTOL * scale, err

    counts = {}
    names = dict(wn_bf16=("wavenet_stack_fwd", "wavenet_stack_bwd"),
                 wn_f32=("wavenet_stack_fwd_f32", "wavenet_stack_bwd_f32"),
                 taco=("tacotron_teacher_forced_train", "tacotron_bptt"))
    for name, rtol, nrtol, scale, steps in (
            ("wn_bf16", DP_BF16_RTOL, DP_BF16_NORM_RTOL, "loss", TP_STEPS),
            ("wn_f32", DP_F32_RTOL, DP_F32_RTOL, "term", TP_STEPS),
            ("taco", DP_BF16_RTOL, DP_BF16_NORM_RTOL, "loss", 1)):
        assert all(x[name]["metrics"] == res[0][name]["metrics"]
                   for x in res), name
        assert len({x[name]["digest"] for x in res}) == 1, \
            f"{name}: the processes drifted"
        hold_dp(f"(a) {name}, {TP_DP}x{TP_MP} processes", res[0][name],
                want[name], rtol, nrtol, scale)
        per = [x[name]["launches"] for x in res]
        print(f"(a) {name}: {steps} step(s); launches per process "
              f"{names[name][0]}/{names[name][1]} {per}; seconds per "
              f"process " + ", ".join(f"{x[name]['seconds']:.3f}"
                                      for x in res)
              + f" (one process, the global batch: "
                f"{want[name]['seconds']:.3f})")
        assert all(c == (steps, steps) for c in per), per
        for j, k in enumerate(names[name]):
            counts[k] = [c[j] for c in per]
    return counts


def gl_bf16_phase(batch, cfg, smi):
    """Phase 31 (b): the bf16 mode on both routes. Returns its two
    `kernels` entries."""
    import math

    import numpy as np
    import torch
    from tacotron2_tpu_torch.ops import griffin_lim as gl
    from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
    from tacotron2_tpu_torch.ops import stft as tst
    m = cfg.audio.max_abs_value
    mels = np.full((batch.shape[0], GL_BF16_FRAMES, batch.shape[2]), -m,
                   np.float32)
    n = min(GL_BF16_FRAMES, batch.shape[1])
    mels[:, :n] = batch[:, :n]
    rel_med = lambda a, b: float((a - b).abs().median() / b.abs().median())
    entries = []
    for n_fft, name in ((cfg.audio.n_fft, "griffin_lim_bf16"),
                        (GL_DFT_NFFT, "griffin_lim_dft_bf16")):
        a = cfg.with_overrides(f"audio.n_fft={n_fft}").audio
        hop, win, iters = a.effective_hop, a.win_size, a.griffin_lim_iters
        kind = glk.route(n_fft)
        plain = (glk.griffin_lim_fft_plain if kind == "fft"
                 else glk.griffin_lim_plain)
        S = gl_magnitudes(mels, a, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(31)
        phase = torch.rand(S.shape, generator=gen, device="cuda") \
            * (2 * math.pi)
        re0, im0 = S * torch.cos(phase), S * torch.sin(phase)
        run = lambda it, bf16=True: glk.fused_griffin_lim(
            S, re0, im0, n_fft, hop, win, it, bf16=bf16)
        glk.launches_bf16 = 0
        y_k = {it: run(it) for it in (0, 1, iters)}
        y_f = {it: run(it, False) for it in (0, 1, iters)}
        assert glk.launches_bf16 == 3, glk.launches_bf16
        y_p = {it: plain(S, re0, im0, n_fft, hop, win, it, True)
               for it in (0, 1, iters)}
        peak0 = float(y_p[0].abs().max())
        abs0 = float((y_k[0] - y_p[0]).abs().max())
        err0, err1 = abs0 / peak0, rel_med(y_k[1], y_p[1])
        apart0 = float((y_k[0] - y_f[0]).abs().max()) / peak0
        apart1 = rel_med(y_k[1], y_f[1])
        err_n = rel_med(y_k[iters], y_p[iters])
        cons = lambda y: float((tst.stft_mag(y.contiguous(), n_fft, hop, win)
                                - S).abs().mean())
        c_k, c_p, c_f = cons(y_k[iters]), cons(y_p[iters]), cons(y_f[iters])
        # the user's path: inv_mel_spectrogram in the bf16 mode, counted
        a16 = dataclasses.replace(a, gl_compute_dtype="bfloat16")
        glk.launches = glk.launches_bf16 = 0
        y_u = gl.inv_mel_spectrogram(torch.as_tensor(mels, device="cuda"),
                                     a16)
        torch.cuda.synchronize()
        launches = glk.launches_bf16
        assert launches == glk.launches == 1 and torch.isfinite(y_u).all()
        ms = cuda_ms(lambda: run(iters), 3)
        f32_ms = cuda_ms(lambda: run(iters, False), 3)
        plain_ms = cuda_ms(lambda: plain(S, re0, im0, n_fft, hop, win, iters,
                                         True), 1)
        lib_ms = cuda_ms(lambda: library_griffin_lim(S, n_fft, hop, win,
                                                     iters, re0, im0), 3)
        Bg, Fg, Kg = S.shape
        ops_s = griffin_lim_flops(Bg, Fg, n_fft, win, iters) / F32_FLOPS
        # S in f32, the start (re, im) in bf16, the waveform in f32
        bytes_s = (Bg * Fg * Kg * (4 + 2 * 2)
                   + Bg * hop * (Fg - 1) * 4) / HBM_BYTES_PER_S
        print(f"(b) bf16 mode, {kind} route, n_fft {n_fft} [{Bg}, {Fg}, "
              f"{Kg}] x {iters}, random-phase start, against "
              f"{plain.__name__}(bf16): iters 0 max |kernel - plain| "
              f"{abs0:.3e} ({err0:.3e} of the peak {peak0:.3e}; the f32 "
              f"kernel {apart0:.3e}), iters 1 median error {err1:.3e} (the "
              f"f32 kernel {apart1:.3e}), iters {iters} {err_n:.3e} (not "
              f"gated); spectral consistency kernel {c_k:.6f} plain "
              f"{c_p:.6f}, f32 kernel {c_f:.6f} (ratio {c_k / c_f:.5f}); "
              f"kernel {ms:.3f} ms, f32 kernel {f32_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, cuFFT f32 {lib_ms:.3f} ms, bound "
              f"{1e3 * max(ops_s, bytes_s):.4f} ms; {smi}")
        assert err0 <= GL_BF16_ITER0_RTOL, err0
        assert err1 <= GL_BF16_ITER1_MED, err1
        assert apart0 > GL_BF16_APART * GL_BF16_ITER0_RTOL, apart0
        assert apart1 > GL_BF16_APART * GL_BF16_ITER1_MED, apart1
        assert c_k <= (1 + GL_BF16_F32_DRIFT) * c_f, (c_k, c_f)
        entries.append(
            {"name": name, "route": "cuda", "gl_route": kind,
             "source": "tacotron2_tpu_torch/csrc/griffin_lim.cu",
             "replaces": "tacotron2_tpu/ops/griffin_lim_kernel.py:108",
             "launches": launches, "max_abs_err": abs0, "ms": ms,
             "plain_ms": plain_ms, "f32_ms": f32_ms,
             "bound_ms": 1e3 * max(ops_s, bytes_s),
             "bound_by": "operations" if ops_s >= bytes_s else "bytes",
             "library_ms": lib_ms})
    return entries


def tf_gl_phase():
    """Phase 31 (c): griffin_lim_tf on the card against the CPU and the TF
    fixture, both presets."""
    import numpy as np
    import torch
    from tacotron2_tpu_torch.config import get_config
    from tacotron2_tpu_torch.ops import griffin_lim as gl
    g = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_dsp.npz"))
    for preset in ("default", "paper"):
        a = get_config(preset).audio
        S = torch.from_numpy(g[f"{preset}/gl_input_pow"])
        for iters in (2, 60):
            args = (a.n_fft, a.effective_hop, a.win_size, iters)
            ts = time.time()
            y_c = gl.griffin_lim_tf(S.cuda(), *args)
            torch.cuda.synchronize()
            card_s = time.time() - ts
            ts = time.time()
            y_h = gl.griffin_lim_tf(S, *args).numpy()
            cpu_s = time.time() - ts
            y_c = y_c.cpu().numpy()
            ref = g[f"{preset}/gl_tf_iters{iters}"]
            peak = float(np.abs(ref).max())
            d = float(np.abs(y_c - y_h).max()) / peak
            d_ref = float(np.abs(y_c - ref).max()) / peak
            d_cpu = float(np.abs(y_h - ref).max()) / peak
            print(f"(c) griffin_lim_tf {preset} [{S.shape[0]}, "
                  f"{S.shape[1]}] x {iters} on the card, of the peak: max "
                  f"|card - CPU| {d:.3e} (gate {GL_TF_CPU_RTOL[iters]:g}), "
                  f"|card - TF fixture| {d_ref:.3e} (gate "
                  f"{GL_TF_FIXTURE_RTOL[iters]:g}; the CPU's {d_cpu:.3e}); "
                  f"card {card_s:.3f} s, CPU {cpu_s:.3f} s")
            assert d <= GL_TF_CPU_RTOL[iters], (preset, iters, d)
            assert d_ref <= GL_TF_FIXTURE_RTOL[iters], (preset, iters, d_ref)


def native_phase():
    """Phase 31 (d): the native data-IO runtime built with the host
    compiler and bit-equal to np.load on the r5 corpus mels."""
    import numpy as np
    from tacotron2_tpu_torch.native import build
    from tacotron2_tpu_torch.native import io as nat
    ts = time.time()
    assert nat.available(), "the native data-IO runtime did not build"
    build_s = time.time() - ts
    mel_dir = os.path.join(R5, "corpus", "mels")
    paths = sorted(os.path.join(mel_dir, f) for f in os.listdir(mel_dir))
    ts = time.time()
    got = nat.read_npy_batch_f32(paths)
    native_s = time.time() - ts
    ts = time.time()
    want = [np.load(p).astype(np.float32) for p in paths]
    numpy_s = time.time() - ts
    same = all(a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(got, want))
    print(f"(d) native runtime ({build.cxx_path()}, built or loaded in "
          f"{build_s:.3f} s): {len(paths)} r5 mels bit-equal to np.load: "
          f"{same}; parallel read {native_s:.4f} s, np.load {numpy_s:.4f} "
          f"s (warm page cache)")
    assert same and len(paths) == 160


def live_phase(texts):
    """Phase 31 (e): `cli live --pipeline` of two stdin lines on the r5
    checkpoints; kernels 1 and 2 counted."""
    import io as stdio

    import numpy as np
    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.data import audio as host_audio
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    hp = ("tacotron.compute_dtype=bfloat16,audio.trim_silence=false,"
          "wavenet.sampler_hbm_delay_threshold=0")
    stdin = sys.stdin
    with tempfile.TemporaryDirectory() as tmp:
        sys.stdin = stdio.StringIO("\n".join(texts[:2]) + "\n")
        dk.rows_launches = wk.launches = 0
        ts = time.time()
        try:
            paths = cli.main([
                "--hparams", hp, "live", "--pipeline", "--checkpoint",
                os.path.join(R5, "taco_ckpt.msgpack"),
                "--wavenet-checkpoint", os.path.join(R5, "wn_ckpt.msgpack"),
                "--output-dir", tmp, "--serve-batch", "2", "--steps",
                str(LIVE_STEPS), "--t-ref", str(T_REF), "--buckets",
                str(T_IN)])
        finally:
            sys.stdin = stdin
        live_s = time.time() - ts
        sr = r5_config().audio.sample_rate
        wavs = [host_audio.load_wav(p, sr) for p in paths]
        lens = [len(w) for w in wavs]
        ok = all(np.isfinite(w).all() for w in wavs)
    print(f"(e) cli live --pipeline, 2 stdin lines: wavs "
          f"{[os.path.basename(p) for p in paths]} of {lens} samples; "
          f"launches kernel 1 {dk.rows_launches}, kernel 2 {wk.launches}; "
          f"{live_s:.3f} s")
    assert len(paths) == 2 and ok and min(lens) > 0
    assert dk.rows_launches > 0 and wk.launches == 2


def tail_phase(tparams, stats, wparams, batch, cfg, texts, seed, smi):
    """Phase 31. Returns ({kernels entry name: launches per process of
    (a)}, the bf16 Griffin-Lim entries)."""
    t0 = phase(31, f"(x) tensor parallelism on a {TP_DP}x{TP_MP} gloo group "
                   f"sharing the card; Griffin-Lim's bf16 mode, "
                   f"griffin_lim_tf, the native runtime, cli live")
    print(f"{smi}; the processes share one card: no time of (a) is a "
          f"scaling figure")
    counts = tp_group_phase(tparams, stats, wparams, seed)
    entries = gl_bf16_phase(batch, cfg, smi)
    tf_gl_phase()
    native_phase()
    live_phase(texts)
    done(31, t0)
    return counts, entries


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of phases 12-14's noise and random weights")
    seed = ap.parse_args(argv).seed
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from tacotron2_tpu_torch import cli
    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.data import audio as host_audio
    from tacotron2_tpu_torch.models.tacotron.decoder import WHOLE
    from tacotron2_tpu_torch.native import build
    from tacotron2_tpu_torch.ops import griffin_lim as gl
    from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
    from tacotron2_tpu_torch.ops import stft as tst
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from tacotron2_tpu_torch.synth.tacotron_synth import TacotronSynthesizer
    from tacotron2_tpu_torch.text import text_to_sequence

    t_start = time.time()
    # full-precision f32 matmuls and convolutions in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device
    t0 = phase(1, "device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"device {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    done(1, t0)

    # ---- 2. build the kernels, one nvcc each, started together
    t0 = phase(2, "build kernels (nvcc, sm_90a)")
    paths = build.build(["decoder", "decoder_rows", "decoder_bwd",
                         "sampler", "griffin_lim", "wavenet_train"])
    for name, path in paths.items():
        print(f"built {name}: {os.path.relpath(path, ROOT)}")
        entry = ""
        for line in build.build_logs.get(name, "").splitlines():
            if "Function properties for" in line:
                # the mangled entry without its anonymous-namespace prefix
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+",
                               "", line.split()[-1])
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")
    done(2, t0)

    # ---- 3. r5 checkpoints through the port's reader and bridge
    t0 = phase(3, "load r5 checkpoints")
    cfg = r5_config()
    tparams, stats, wparams = load_checkpoints(
        os.path.join(R5, "taco_ckpt.msgpack"),
        os.path.join(R5, "wn_ckpt.msgpack"))
    B = len(HELD_ROWS)
    prog = TextToWavProgram(cfg, tparams, stats, wparams, batch=B,
                            steps=MAX_STEPS, t_in=T_IN, t_ref=T_REF,
                            device="cuda", seed=1234, keep_intermediates=True)
    print(f"memory width {prog.memory_width}, decode weights "
          f"{prog.dec_params.l1_wp.dtype}, steps {MAX_STEPS}, "
          f"t_audio {prog.t_audio}")
    done(3, t0)

    # ---- 4. serve held-out texts at full width
    t0 = phase(4, f"serve {B} held-out texts")
    with open(os.path.join(R5, "report.json")) as f:
        report = json.load(f)
    held = held_out_texts()
    assert [len(t) for t in held] == report["held_text_chars"], \
        "held-out texts do not match report.json"
    texts = [held[i - 128] for i in HELD_ROWS]
    seqs = [text_to_sequence(t, cfg.data.cleaners) for t in texts]
    ids = np.zeros((B, T_IN), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    lengths = np.asarray([len(s) for s in seqs])
    gt = [np.load(os.path.join(R5, "corpus", "mels", f"mel-{i}.npy"))
          for i in HELD_ROWS]
    refs = np.stack([m[:T_REF] for m in gt]).astype(np.float32)

    dk.rows_launches = dk.launches = 0
    wk.launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    samples, wav_len, mel, stops, mel_len = prog(ids, lengths, refs, refs)
    torch.cuda.synchronize()
    serve_s = time.time() - ts
    launches = {"tacotron_decoder": dk.rows_launches,
                "wavenet_sampler": wk.launches}
    print(f"serve: {serve_s:.3f} s for {B} utterances; launches {launches}")
    assert all(n > 0 for n in launches.values()), launches
    assert dk.launches == 0, "the serve decode left csrc/decoder_rows.cu"

    samples, wav_len = samples.cpu().numpy(), wav_len.cpu().numpy()
    mel, mel_len = mel.cpu().numpy(), mel_len.cpu().numpy()
    stops = stops.cpu().numpy()
    kept = int(wav_len.sum())
    audio_s = kept / cfg.audio.sample_rate
    print(f"serve: {kept} samples kept after trimming = {audio_s:.4f} s of "
          f"audio at {cfg.audio.sample_rate} Hz; realtime factor "
          f"{audio_s / serve_s:.4f}")
    assert samples.shape == (B, prog.t_audio) and mel.shape[0] == B
    assert np.isfinite(samples).all() and np.isfinite(mel).all()
    corrs = []
    for b in range(B):
        n = int(wav_len[b])
        rms = float(np.sqrt(np.mean(samples[b, :n] ** 2))) if n else 0.0
        fm = mel[b, :int(mel_len[b])]
        c = float(np.corrcoef(time_resample(fm, len(gt[b])).ravel(),
                              gt[b].ravel())[0, 1])
        corrs.append(c)
        print(f"row {HELD_ROWS[b]}: chars {len(texts[b])} stop step "
              f"{int(mel_len[b])} (gt {len(gt[b])} frames) wav "
              f"{n} samples rms {rms:.4f} free-run mel corr {c:.4f} "
              f"(TPU run {report['taco_freerun_corr'][HELD_ROWS[b] - 128]})")
        assert int(mel_len[b]) < prog.frames, f"row {b}: stop never fired"
        assert n == int(mel_len[b]) * prog.hop and 0.0 < rms < 1.0
    # The TPU run recorded 0.965-0.977 on these texts. Prenet dropout stays
    # on at inference and draws other random numbers here, and bf16 rounds
    # differently, so the gate is loose: a decoder with a wiring fault
    # (wrong gate order, transposed weights) scores far below 0.9.
    print(f"free-run mel corr: min {min(corrs):.4f} mean "
          f"{np.mean(corrs):.4f}")
    assert min(corrs) >= 0.9, corrs
    done(4, t0)

    # ---- 5. each kernel against its plain version, same inputs and noise
    t0 = phase(5, "kernels vs plain versions")
    im = prog.intermediates
    tc = cfg.tacotron
    r, K = tc.outputs_per_step, tc.early_stop_block
    dargs = (prog.dec_params, cfg, im["keys"], im["memory"], im["mask"],
             im["drop"])
    dkw = dict(steps=MAX_STEPS, early_stop_block=K, emit_alignments=False)
    f_k, s_k, _ = dk.decode(*dargs, **dkw, kernel_weights=prog.dec_kernel)
    f_p, s_p, _ = dk.decode_plain(*dargs, **dkw)
    # the first 32 steps, as the rounded function (see replay_gate)
    T, M = im["memory"].shape[1:]
    st_z = dk.init_decoder_state(cfg, B, T, M, "cuda")
    d32 = im["drop"][:, :32].contiguous()
    dp_u = f32_activations(prog.dec_params)
    dec_err = replay_gate(
        "decoder over the first 32 steps",
        lambda st, d: dk.decode_block(*dargs[:5], st, d, casts=WHOLE,
                                      kernel_weights=prog.dec_kernel),
        lambda st, d: dk.decode_block_plain(*dargs[:5], st, d, casts=WHOLE),
        lambda st, d: dk.decode_block_plain(dp_u, *dargs[1:5], st, d),
        st_z, d32, (f_k[:, :32 * r],))
    torch.cuda.synchronize()
    f_k, s_k, f_p, s_p = (x.cpu().numpy() for x in (f_k, s_k, f_p, s_p))
    fk, fp = first_fire(s_k, r, K, MAX_STEPS), first_fire(s_p, r, K, MAX_STEPS)
    print(f"decoder: max |kernel - plain| over the first 32 steps "
          f"{dec_err:.3e}; stop steps kernel {[f for f, _ in fk]} plain "
          f"{[f for f, _ in fp]}")
    # the rerun repeats the serve run's decode bit for bit (no atomics;
    # every sum has a fixed order)
    assert np.array_equal(s_k, stops), "decode kernel is not deterministic"
    for b in range(B):
        assert fk[b][0] is not None and fp[b][0] is not None
        # over hundreds of steps the order differences may move a stop
        # decision that sits near 0.5 by a step or two
        assert abs(fk[b][0] - fp[b][0]) <= 2, (b, fk[b], fp[b])
        n = min(fk[b][0], fp[b][0]) * r
        c = float(np.corrcoef(f_k[b, :n].ravel(), f_p[b, :n].ravel())[0, 1])
        assert c >= 0.99, (b, c)

    W = SAMPLER_WINDOW
    c_w = im["c_up"][:, :W].contiguous()
    c_w30 = c_w.float().cpu().numpy()       # phase 30's sampler window
    n_w = im["noise"][:, :, :W].contiguous()
    sp = prog.sampler_params
    bf16 = dict(cache_dtype=torch.bfloat16, weight_dtype=torch.bfloat16)
    assert (prog.cache_dtype, prog.weight_dtype) == tuple(bf16.values())
    kw32 = wk.pack_weights(sp, cfg)
    y_k = wk.sample(sp, cfg, c_w, n_w, kernel_weights=prog.sampler_kernel)
    y_p = wk.sample_plain(sp, cfg, c_w, n_w, **bf16)
    y_r, _ = wk.teacher_forced_replay(sp, cfg, c_w, n_w, y_k, **bf16)
    y_r32, _ = wk.teacher_forced_replay(sp, cfg, c_w, n_w, y_k)
    y_k32 = wk.sample(sp, cfg, c_w, n_w, kernel_weights=kw32)
    y_p32 = wk.sample_plain(sp, cfg, c_w, n_w)
    torch.cuda.synchronize()
    y_k, y_p, y_r, y_r32, y_k32, y_p32 = (x.cpu().numpy() for x in (
        y_k, y_p, y_r, y_r32, y_k32, y_p32))
    smp8 = (y_k32, y_k)  # phase 22 holds B=1, 16 and 32 to these rows
    smp_err = float(np.abs(y_k32 - y_p32).max())
    bf_free = float(np.abs(y_k - y_p).max())
    bf_err = float(np.abs(y_k - y_r).max())
    bf_err32 = float(np.abs(y_k - y_r32).max())
    print(f"sampler over the first {W} samples: f32 max |kernel - plain| "
          f"{smp_err:.3e}; bf16 max |kernel - plain| {bf_free:.3e} free "
          f"run (not gated), {bf_err:.3e} against the plain version "
          f"replaying the kernel's trajectory ({bf_err32:.3e} against the "
          f"f32 plain version on it); bf16 kernel vs f32 plain free run "
          f"{float(np.abs(y_k - y_p32).max()):.3e}; the bf16 kernel equals "
          f"the serve run's samples: "
          f"{bool(np.array_equal(y_k, samples[:, :W]))}")
    assert smp_err <= SAMPLER_F32_ATOL, smp_err
    assert bf_err <= SAMPLER_REPLAY_ATOL["bfloat16"], bf_err
    assert bf_err <= 0.5 * bf_err32, (bf_err, bf_err32)
    assert np.array_equal(y_k, samples[:, :W]), "kernel is not deterministic"
    done(5, t0)

    # ---- 6. times and bounds
    t0 = phase(6, "time kernels and plain versions")
    dec_ms = cuda_ms(lambda: dk.decode(
        *dargs, **dkw, kernel_weights=prog.dec_kernel), 3)
    dec_plain_ms = cuda_ms(lambda: dk.decode_plain(*dargs, **dkw), 1)
    smp_ms = cuda_ms(lambda: wk.sample(sp, cfg, c_w, n_w,
                                       kernel_weights=kw32), 3)
    smp_plain_ms = cuda_ms(lambda: wk.sample_plain(sp, cfg, c_w, n_w), 1)
    bf_ms = cuda_ms(lambda: wk.sample(
        sp, cfg, c_w, n_w, kernel_weights=prog.sampler_kernel), 3)
    bf_plain_ms = cuda_ms(lambda: wk.sample_plain(sp, cfg, c_w, n_w,
                                                  **bf16), 1)

    # decoder bound: each input read once, the output written once, and
    # the operations of the steps the batch-wide early-stop rule runs
    dp = prog.dec_params
    T, M = im["memory"].shape[1:]
    steps_run = sum(run for _, run in fk)
    dec_bound_s, dec_bound_by = decode_bound_s(
        dp, cfg, B, T, M, MAX_STEPS, steps_run, align=False)

    # sampler bounds over the timed window
    s_bound_s, s_bound_by = sampler_bound_s(sp, cfg, B, W, False)
    bf_bound_s, bf_bound_by = sampler_bound_s(sp, cfg, B, W, True)

    kernels = [
        {"name": "tacotron_decoder", "route": "cuda",
         "source": "tacotron2_tpu_torch/csrc/decoder_rows.cu",
         "replaces": "tacotron2_tpu/ops/tacotron_decoder_kernel.py:842",
         "launches": None, "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms,
         "bound_ms": 1e3 * dec_bound_s, "bound_by": dec_bound_by,
         "library_ms": None},
        {"name": "wavenet_sampler", "route": "cuda",
         "source": "tacotron2_tpu_torch/csrc/sampler.cu",
         "replaces": "tacotron2_tpu/ops/wavenet_kernel.py:180",
         "launches": None, "max_abs_err": smp_err,
         "ms": smp_ms, "plain_ms": smp_plain_ms,
         "bound_ms": 1e3 * s_bound_s, "bound_by": s_bound_by,
         "library_ms": None},
        {"name": "wavenet_sampler_bf16", "route": "cuda",
         "source": "tacotron2_tpu_torch/csrc/sampler.cu",
         "replaces": "tacotron2_tpu/ops/wavenet_kernel.py:180",
         "launches": launches["wavenet_sampler"], "max_abs_err": bf_err,
         "ms": bf_ms, "plain_ms": bf_plain_ms,
         "bound_ms": 1e3 * bf_bound_s, "bound_by": bf_bound_by,
         "library_ms": None},
    ]
    print(f"decoder timed on the serve inputs: B={B}, T_in={T}, "
          f"{MAX_STEPS} steps, {steps_run} row-steps run: kernel "
          f"{dec_ms:.3f} ms, plain {dec_plain_ms:.3f} ms; Gaussian sampler "
          f"timed on the first {W} samples of the serve inputs, B={B}: f32 "
          f"kernel {smp_ms:.3f} ms, plain {smp_plain_ms:.3f} ms, bound "
          f"{1e3 * s_bound_s:.4f} ms ({s_bound_by}); bf16 kernel "
          f"{bf_ms:.3f} ms, plain {bf_plain_ms:.3f} ms, bound "
          f"{1e3 * bf_bound_s:.4f} ms ({bf_bound_by}); {chain_us(smp_ms, W, cfg)} "
          f"(f32), {chain_us(bf_ms, W, cfg)} (bf16)")
    done(6, t0)
    by_name = {k["name"]: k for k in kernels}

    # ---- 7. quality of the served wavs, as the r5 script measures it
    t0 = phase(7, "quality of the served wavs")
    a = cfg.audio
    m = a.max_abs_value
    rows = [i - 128 for i in HELD_ROWS]
    tpu_t2w = [report["text_to_wav_mel_corr"][i] for i in rows]
    tpu_voc = [report["vocoder_fidelity_corr"][i] for i in rows]
    assert abs(np.mean(tpu_t2w) - TPU_T2W_MEAN) < 5e-4
    assert abs(np.mean(tpu_voc) - TPU_VOC_MEAN) < 5e-4
    t2w, voc = [], []
    for b in range(B):
        free = np.clip(mel[b, :int(mel_len[b])], -m, m)
        q = wav_quality(samples[b, :int(wav_len[b])], free, gt[b], a)
        t2w.append(q[0])
        voc.append(q[1])
        print(f"row {HELD_ROWS[b]}: text_to_wav_mel_corr {q[0]:.4f} (TPU run "
              f"{tpu_t2w[b]}) vocoder_fidelity_corr {q[1]:.4f} (TPU run "
              f"{tpu_voc[b]})")
    print(f"text_to_wav_mel_corr mean {np.mean(t2w):.4f} (TPU run "
          f"{np.mean(tpu_t2w):.4f}); vocoder_fidelity_corr mean "
          f"{np.mean(voc):.4f} (TPU run {np.mean(tpu_voc):.4f})")
    # The TPU run's rows lie in 0.752-0.886. WaveNet draws other noise
    # here, so each row may move; a vocoder or mel wiring fault drops the
    # correlations far below 0.7.
    assert min(t2w) >= 0.70 and min(voc) >= 0.70, (t2w, voc)
    assert abs(np.mean(t2w) - TPU_T2W_MEAN) <= 0.05, t2w
    assert abs(np.mean(voc) - TPU_VOC_MEAN) <= 0.05, voc
    done(7, t0)

    # ---- 8. Tacotron eval synthesis: synthesize -> mels_to_wavs
    t0 = phase(8, f"Tacotron eval synthesis of the {B} texts")
    synth = TacotronSynthesizer(cfg, tparams, stats, device="cuda",
                                seed=1234, keep_intermediates=True)
    ref_list = [g[:T_REF] for g in gt]
    dk.rows_launches = 0
    glk.launches = glk.launches_fft = glk.launches_dft = 0
    torch.cuda.synchronize()
    ts = time.time()
    out8 = synth.synthesize(texts, ref_list, ref_list, max_steps=MAX_STEPS)
    wavs8 = synth.mels_to_wavs(out8["mels"])
    torch.cuda.synchronize()
    eval_s = time.time() - ts
    eval_launches = {"tacotron_decoder": dk.rows_launches,
                     "griffin_lim": glk.launches}
    gl_routes = {"eval": (glk.launches_fft, glk.launches_dft)}
    im8 = synth.intermediates
    audio8 = sum(len(w) for w in wavs8) / a.sample_rate
    print(f"eval: {eval_s:.3f} s for {B} utterances ({audio8:.4f} s of "
          f"audio, realtime factor {audio8 / eval_s:.4f}); route "
          f"{im8['route']}; launches {eval_launches}")
    assert all(n > 0 for n in eval_launches.values()), eval_launches
    assert im8["route"] == "fused"
    hop = a.effective_hop
    diags, t2w_gl = [], []
    for b in range(B):
        L, mel_b = out8["lengths"][b], out8["mels"][b]
        d = diagonality(out8["alignments"][b])
        c = float(np.corrcoef(time_resample(mel_b, len(gt[b])).ravel(),
                              gt[b].ravel())[0, 1])
        q = wav_quality(wavs8[b], mel_b, gt[b], a)
        diags.append(d)
        t2w_gl.append(q[0])
        print(f"row {HELD_ROWS[b]}: stop step {L} diagonality {d:.4f} (TPU "
              f"run {report['heldout_free_run_diagonality'][rows[b]]}) "
              f"free-run mel corr {c:.4f} Griffin-Lim wav {len(wavs8[b])} "
              f"samples text_to_wav_mel_corr {q[0]:.4f} "
              f"vocoder_fidelity_corr {q[1]:.4f}")
        assert L < MAX_STEPS * r, f"row {b}: stop never fired"
        assert d >= 0.95 and c >= 0.9, (b, d, c)
        assert len(wavs8[b]) == hop * (mel_b.shape[0] - 1)
        assert np.isfinite(wavs8[b]).all() and np.isfinite(mel_b).all()
    print(f"Griffin-Lim route text_to_wav_mel_corr: min {min(t2w_gl):.4f} "
          f"mean {np.mean(t2w_gl):.4f}")
    # the same chain of launches on the same inputs repeats the stop
    # probabilities bit for bit
    _, s_re, _ = dk.decode(synth.dec_params, cfg, im8["keys"], im8["memory"],
                           im8["mask"], im8["drop"], steps=MAX_STEPS,
                           early_stop_block=K,
                           kernel_weights=synth.dec_kernel)
    assert np.array_equal(s_re.cpu().numpy(), out8["stop_tokens"]), \
        "decode kernel is not deterministic"
    done(8, t0)

    # ---- 9. long inputs through the block route; the command line
    t0 = phase(9, "long inputs (> 256 padded characters), block route")
    long_texts = []
    for i in range(4):
        parts = []
        while len(text_to_sequence(" ".join(parts), cfg.data.cleaners)) \
                <= 256:
            parts.append(held[(8 * i + len(parts)) % len(held)])
        long_texts.append(" ".join(parts))
    dk.rows_launches = 0
    torch.cuda.synchronize()
    ts = time.time()
    out9 = synth.synthesize(long_texts, ref_list[:4], ref_list[:4])
    torch.cuda.synchronize()
    long_s = time.time() - ts
    long_launches = dk.rows_launches
    im9 = synth.intermediates
    B9, T9, M9 = im9["memory"].shape
    kf = im9["k"]
    print(f"long: {long_s:.3f} s for 4 utterances of padded length {T9}; "
          f"route {im9['route']} in blocks of {kf} steps; decode launches "
          f"{long_launches}")
    assert im9["route"] == "block" and T9 > 256 and long_launches > 0
    for b in range(4):
        d = diagonality(out9["alignments"][b])
        print(f"long row {b}: {len(long_texts[b])} chars, stop step "
              f"{out9['lengths'][b]}, diagonality {d:.4f} (not gated: the "
              f"r5 model saw 40-80 characters)")
        assert np.isfinite(out9["mels"][b]).all()
    # kernel vs plain: one 32-step block from the zero state, on the run's
    # inputs and dropout multipliers
    st0 = dk.init_decoder_state(cfg, B9, T9, M9, "cuda")
    d32 = im9["drop"][:, :32].contiguous()
    blk_args = (synth.dec_params, cfg, im9["keys"], im9["memory"], im9["mask"])
    got = dk.decode_block(*blk_args, st0, d32,
                          kernel_weights=synth.dec_kernel)
    # the rounded function (see replay_gate); a moved argmax shows in the
    # alignments and the cumulative weights
    dp_u = f32_activations(synth.dec_params)
    blk_err = replay_gate(
        f"block route over 32 steps at T_in={T9}",
        lambda st, d: dk.decode_block(*blk_args, st, d,
                                      kernel_weights=synth.dec_kernel),
        lambda st, d: dk.decode_block_plain(*blk_args, st, d),
        lambda st, d: dk.decode_block_plain(dp_u, *blk_args[1:], st, d),
        st0, d32, got)
    with tempfile.TemporaryDirectory() as tmp:
        tl = os.path.join(tmp, "texts.txt")
        with open(tl, "w", encoding="utf-8") as f:
            f.write(f"{texts[0]}\n{long_texts[0]}\n")
        ref_path = os.path.join(tmp, "ref.npy")
        np.save(ref_path, ref_list[0])
        ts = time.time()
        map_path = cli.main([
            "--hparams", "tacotron.compute_dtype=bfloat16,"
            "audio.trim_silence=false", "synthesize", "--model", "Tacotron",
            "--mode", "eval", "--checkpoint",
            os.path.join(R5, "taco_ckpt.msgpack"), "--ref-mel-emt", ref_path,
            "--text-list", tl, "--output-dir", os.path.join(tmp, "out")])
        rows_cli = open(map_path, encoding="utf-8").read().splitlines()
        assert len(rows_cli) == 2
        for i, row in enumerate(rows_cli):
            mel_i = np.load(row.split("|")[0])
            wav_path = os.path.join(os.path.dirname(map_path), "wavs",
                                    f"wav-eval-{i}.wav")
            with wave.open(wav_path, "rb") as f:
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            print(f"cli synthesize row {i}: {len(row.split('|')[1])} chars, "
                  f"mel {mel_i.shape}, wav {len(pcm)} samples")
            assert np.isfinite(mel_i).all() and len(pcm) > a.sample_rate // 2
        print(f"cli synthesize: {time.time() - ts:.3f} s")
    done(9, t0)

    # ---- 10. Griffin-Lim: kernel vs plain, a tone, the G-L program
    t0 = phase(10, "Griffin-Lim kernel")
    n_fft, win, iters = a.n_fft, a.win_size, a.griffin_lim_iters
    Fg = -(-max(x.shape[0] for x in out8["mels"]) // 64) * 64 + 1
    batch = np.stack([np.pad(x, ((0, Fg - x.shape[0]), (0, 0)),
                             constant_values=-m) for x in out8["mels"]])
    S = gl_magnitudes(batch.astype(np.float32), a, "cuda")
    zeros = torch.zeros_like(S)
    y_k0 = glk.fused_griffin_lim(S, S, zeros, n_fft, hop, win, 0)
    y_p0 = glk.griffin_lim_plain(S, S, zeros, n_fft, hop, win, 0)
    y_k4 = glk.fused_griffin_lim(S, S, zeros, n_fft, hop, win, 4)
    y_p4 = glk.griffin_lim_plain(S, S, zeros, n_fft, hop, win, 4)
    y_k = glk.fused_griffin_lim(S, S, zeros, n_fft, hop, win, iters)
    y_p = glk.griffin_lim_plain(S, S, zeros, n_fft, hop, win, iters)
    torch.cuda.synchronize()
    y_d4 = library_griffin_lim(S.double(), n_fft, hop, win, 4)
    gl_err = float((y_k0 - y_p0).abs().max())
    gl_err4 = float((y_k4 - y_p4).abs().max())
    rms = lambda d: float(d.double().pow(2).mean().sqrt())
    rms_k4, rms_p4 = rms(y_k4 - y_d4), rms(y_p4 - y_d4)

    def consistency(y):
        return float((tst.stft_mag(y.contiguous(), n_fft, hop, win)
                      - S).abs().mean())

    c_k, c_p = consistency(y_k), consistency(y_p)
    print(f"griffin-lim [B={S.shape[0]}, F={Fg}, K={S.shape[2]}]: iters 0 "
          f"max |kernel - plain| {gl_err:.3e} (samples up to "
          f"{float(y_p0.abs().max()):.3e}); iters 4 max |kernel - plain| "
          f"{gl_err4:.3e} (samples up to {float(y_p4.abs().max()):.3e}), "
          f"rms distance from float64 kernel {rms_k4:.3e} plain "
          f"{rms_p4:.3e}; "
          f"{iters} iterations spectral consistency kernel {c_k:.6f} plain "
          f"{c_p:.6f} (ratio {c_k / c_p:.7f})")
    # iters 0 is one iSTFT: sums of 2,050 3xTF32 products in another order
    assert gl_err <= 1e-4, gl_err
    # iters 4 runs every part of the kernel (the analysis product over all
    # tiles, the magnitude projection); on these mels the f32 plain version
    # itself lies ~1e-2 from float64 there (phases of bins near zero follow
    # rounding noise), so the kernel's distance from float64 is also held
    # to within 1.5× the plain version's
    assert gl_err4 <= GL_ITERS4_ATOL, gl_err4
    assert rms_k4 <= GL_ITERS4_F64_RATIO * rms_p4, (rms_k4, rms_p4)
    # 60 iterations: the spectral consistency (tests/test_pallas_kernels.py
    # :237's measure), within 1% of the plain version's
    assert c_k <= 1.01 * c_p, (c_k, c_p)
    y_k = y_k.cpu().numpy()
    for b, x in enumerate(out8["mels"]):
        n = hop * (x.shape[0] - 1)
        same = host_audio.inv_preemphasis(y_k[b, :n], a.preemphasis,
                                          a.preemphasize)
        assert np.array_equal(same, wavs8[b]), "G-L kernel not deterministic"
    sr = a.sample_rate
    tone = (0.2 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)).astype(
        np.float32)
    mel_tone = host_audio.mel_spectrogram(
        host_audio.preemphasis(tone, a.preemphasis, a.preemphasize), a)
    y_tone = host_audio.inv_preemphasis(gl.inv_mel_spectrogram(
        torch.as_tensor(mel_tone, device="cuda"), a).cpu().numpy(),
        a.preemphasis, a.preemphasize)
    spec = np.abs(np.fft.rfft(y_tone))
    peak = float(np.fft.rfftfreq(len(y_tone), 1.0 / sr)[spec.argmax()])
    print(f"440 Hz tone through mel -> Griffin-Lim: peak at {peak:.2f} Hz")
    assert abs(peak - 440.0) < 5.0, peak
    prog_gl = TextToWavProgram(cfg, tparams, stats, None, batch=B,
                               steps=MAX_STEPS, t_in=T_IN, t_ref=T_REF,
                               device="cuda", seed=1234,
                               vocoder="griffin_lim")
    dk.rows_launches = 0
    glk.launches = glk.launches_fft = glk.launches_dft = 0
    wavs_gl = prog_gl.synthesize(texts, ref_list, ref_list)
    torch.cuda.synchronize()
    gl_prog_launches = {"tacotron_decoder": dk.rows_launches,
                        "griffin_lim": glk.launches}
    gl_routes["griffin_lim serve"] = (glk.launches_fft, glk.launches_dft)
    q_gl = [wav_quality(w, np.clip(out8["mels"][b], -m, m), gt[b], a)[0]
            for b, w in enumerate(wavs_gl)]
    print(f"TextToWavProgram(vocoder=griffin_lim): launches "
          f"{gl_prog_launches}; text_to_wav_mel_corr per row "
          f"{[round(x, 4) for x in q_gl]}")
    assert all(n > 0 for n in gl_prog_launches.values())
    assert all(len(w) and np.isfinite(w).all() for w in wavs_gl)
    done(10, t0)

    # ---- 11. time the block decode and Griffin-Lim
    t0 = phase(11, "time the block decode and Griffin-Lim")
    drop_blk = im9["drop"]
    blk_ms = cuda_ms(lambda: dk.decode_block(
        *blk_args, st0, drop_blk, kernel_weights=synth.dec_kernel), 3)
    blk_plain_ms = cuda_ms(lambda: dk.decode_block_plain(
        *blk_args, st0, drop_blk), 1)
    blk_bound_s, blk_bound_by = decode_bound_s(
        synth.dec_params, cfg, B9, T9, M9, kf, B9 * kf, align=True)
    gl_ms = cuda_ms(lambda: glk.fused_griffin_lim(
        S, S, zeros, n_fft, hop, win, iters), 3)
    gl_plain_ms = cuda_ms(lambda: glk.griffin_lim_plain(
        S, S, zeros, n_fft, hop, win, iters), 1)
    gl_lib_ms = cuda_ms(lambda: library_griffin_lim(
        S, n_fft, hop, win, iters), 3)
    lib_err = float((library_griffin_lim(S, n_fft, hop, win, 0)
                     - y_p0).abs().max())
    Bg, Fg, Kg = S.shape
    gl_ops_s = griffin_lim_flops(Bg, Fg, n_fft, win, iters) / F32_FLOPS
    gl_bytes_s = (3 * Bg * Fg * Kg + Bg * hop * (Fg - 1)) * 4 / HBM_BYTES_PER_S
    # what the DFT route's design costs at best: its 2·iters+1 dense DFT
    # products over the support, three TF32 products each (3xTF32)
    gl_dft_s = 3 * Bg * (2 * iters + 1) * 2 * Fg * win * 2 * Kg / TF32_FLOPS
    print(f"block decode timed on the long inputs: B={B9}, T_in={T9}, one "
          f"{kf}-step block: kernel {blk_ms:.3f} ms, plain "
          f"{blk_plain_ms:.3f} ms; griffin-lim timed on the eval batch "
          f"[{Bg}, {Fg}, {Kg}], {iters} iterations: kernel {gl_ms:.3f} ms, "
          f"({glk.route(n_fft)} route), plain {gl_plain_ms:.3f} ms, "
          f"torch.stft/istft {gl_lib_ms:.3f} ms "
          f"(iters 0 vs plain {lib_err:.1e}); bounds decode block "
          f"{1e3 * blk_bound_s:.3f} ms, griffin-lim "
          f"{1e3 * max(gl_ops_s, gl_bytes_s):.4f} ms (transforms as FFTs "
          f"at the f32 rate {1e3 * gl_ops_s:.4f} ms, bytes "
          f"{1e3 * gl_bytes_s:.4f} ms); the DFT route's dense 3xTF32 "
          f"products at the TF32 rate {1e3 * gl_dft_s:.3f} ms")
    by_name["tacotron_decoder"]["launches"] = \
        eval_launches["tacotron_decoder"]
    kernels[1:1] = [
        {"name": "tacotron_decoder_block", "route": "cuda",
         "source": "tacotron2_tpu_torch/csrc/decoder_rows.cu",
         "replaces": "tacotron2_tpu/ops/tacotron_decoder_kernel.py:321",
         "launches": long_launches, "max_abs_err": blk_err,
         "ms": blk_ms, "plain_ms": blk_plain_ms,
         "bound_ms": 1e3 * blk_bound_s, "bound_by": blk_bound_by,
         "library_ms": None}]
    kernels.append(
        {"name": "griffin_lim", "route": "cuda", "gl_route": glk.route(n_fft),
         "source": "tacotron2_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "tacotron2_tpu/ops/griffin_lim_kernel.py:108",
         "launches": eval_launches["griffin_lim"], "max_abs_err": gl_err,
         "ms": gl_ms, "plain_ms": gl_plain_ms,
         "bound_ms": 1e3 * max(gl_ops_s, gl_bytes_s),
         "bound_by": "operations" if gl_ops_s >= gl_bytes_s else "bytes",
         "library_ms": gl_lib_ms})
    done(11, t0)

    # ---- 12. (a) synthesize --model Tacotron-2: eval mels, then WaveNet
    t0 = phase(12, f"(a) synthesize --model Tacotron-2 of the {B} texts")
    with tempfile.TemporaryDirectory() as tmp:
        tl = os.path.join(tmp, "texts.txt")
        with open(tl, "w", encoding="utf-8") as f:
            f.write("".join(f"{t}\n" for t in texts))
        ref_path = os.path.join(tmp, "ref.npy")
        np.save(ref_path, ref_list[0])
        dk.rows_launches = 0
        wk.launches = 0
        glk.launches = 0
        torch.cuda.synchronize()
        ts = time.time()
        wav_paths = cli.main([
            "--hparams", "tacotron.compute_dtype=bfloat16,"
            "audio.trim_silence=false,train.wavenet_synthesis_batch_size="
            f"{B},tacotron.max_iters={MAX_STEPS}", "synthesize", "--model",
            "Tacotron-2", "--checkpoint",
            os.path.join(R5, "taco_ckpt.msgpack"), "--wavenet-checkpoint",
            os.path.join(R5, "wn_ckpt.msgpack"), "--ref-mel-emt", ref_path,
            "--text-list", tl, "--output-dir", os.path.join(tmp, "out"),
            "--seed", str(seed)])
        torch.cuda.synchronize()
        t2_s = time.time() - ts
        t2_launches = {"tacotron_decoder": dk.rows_launches,
                       "griffin_lim": glk.launches,
                       "wavenet_sampler": wk.launches}
        rows_t2 = open(os.path.join(tmp, "out", "eval", "map.txt"),
                       encoding="utf-8").read().splitlines()
        assert len(rows_t2) == B and len(wav_paths) == B, wav_paths
        voc_t2, audio_t2 = [], 0
        for b, (row, wav_path) in enumerate(zip(rows_t2, wav_paths)):
            mel_b = np.load(row.split("|")[0])
            with wave.open(wav_path, "rb") as f:
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            wav_b = pcm.astype(np.float32) / 32767
            assert len(wav_b) == mel_b.shape[0] * hop, (b, len(wav_b))
            assert np.isfinite(mel_b).all() and np.abs(pcm).max() > 0
            audio_t2 += len(wav_b)
            voc_t2.append(wav_quality(wav_b, mel_b, gt[b], a)[1])
            print(f"Tacotron-2 row {HELD_ROWS[b]}: mel {mel_b.shape}, wav "
                  f"{len(wav_b)} samples, vocoder_fidelity_corr "
                  f"{voc_t2[-1]:.4f} (TPU run {tpu_voc[b]})")
        # --model WaveNet alone on two rows of the map (A) wrote
        wk.launches = 0
        wn_paths = cli.main([
            "--hparams", "train.wavenet_synthesis_batch_size=2",
            "synthesize", "--model", "WaveNet", "--wavenet-checkpoint",
            os.path.join(R5, "wn_ckpt.msgpack"), "--mels-map",
            os.path.join(tmp, "out", "eval", "map.txt"), "--limit", "2",
            "--output-dir", os.path.join(tmp, "wn")])
        wn_launches = wk.launches
        for row, p in zip(rows_t2, wn_paths):
            with wave.open(p, "rb") as f:
                n = f.getnframes()
            assert n == np.load(row.split("|")[0]).shape[0] * hop, (p, n)
        print(f"synthesize --model WaveNet --limit 2: {len(wn_paths)} wavs, "
              f"sampler launches {wn_launches}")
        assert len(wn_paths) == 2 and wn_launches > 0
    print(f"Tacotron-2: {t2_s:.3f} s for {B} texts, "
          f"{audio_t2 / a.sample_rate:.4f} s of audio; launches "
          f"{t2_launches}; vocoder_fidelity_corr min {min(voc_t2):.4f} mean "
          f"{np.mean(voc_t2):.4f} (TPU run {np.mean(tpu_voc):.4f})")
    assert all(n > 0 for n in t2_launches.values()), t2_launches
    # the f32 Gaussian kernel, as the r5 config's sampler dtypes ask
    by_name["wavenet_sampler"]["launches"] = t2_launches["wavenet_sampler"]
    # as phase 7: WaveNet draws other noise here, so each row may move; a
    # vocoder or mel wiring fault drops the correlation far below 0.7
    assert min(voc_t2) >= 0.70, voc_t2
    assert abs(np.mean(voc_t2) - TPU_VOC_MEAN) <= 0.05, voc_t2
    done(12, t0)

    # ---- 13-14. the mixture-of-logistics and categorical heads
    from tacotron2_tpu_torch.config import get_config
    from tacotron2_tpu_torch.synth.wavenet_synth import WaveNetSynthesizer
    mels_h = [g[:HEAD_FRAMES] for g in gt]
    cfg_mol = get_config("paper")
    cfg_cat = get_config("default", "wavenet.input_type=mulaw-quantize,"
                         "wavenet.quantize_channels=256,"
                         "wavenet.out_channels=256")
    for n, name, cfg_h in ((13, "mol", cfg_mol), (14, "categorical",
                                                  cfg_cat)):
        wn_h = cfg_h.wavenet
        t0 = phase(n, f"({'bc'[n - 13]}) the {name} head: {wn_h.layers} "
                   f"layers, R={wn_h.residual_channels}, "
                   f"G={wn_h.gate_channels}, S={wn_h.skip_out_channels}, "
                   f"out {wn_h.out_channels}, hop {cfg_h.audio.effective_hop},"
                   f" upsample {tuple(wn_h.upsample_scales)}")
        tree = random_wavenet_tree(cfg_h, seed)
        for dt in ("float32", "bfloat16"):
            cfg_d = cfg_h.with_overrides(
                f"wavenet.sampler_cache_dtype={dt},"
                f"wavenet.sampler_weight_dtype={dt}")
            ws = WaveNetSynthesizer(cfg_d, tree, device="cuda", seed=seed,
                                    keep_intermediates=True)
            wk.launches = 0
            torch.cuda.synchronize()
            ts = time.time()
            wavs_h = ws.synthesize(mels_h)
            torch.cuda.synchronize()
            syn_s = time.time() - ts
            n_launch = wk.launches
            hop_h = cfg_h.audio.effective_hop
            print(f"{name} {dt}: WaveNetSynthesizer on {B} mels of "
                  f"{HEAD_FRAMES} frames: {syn_s:.3f} s, "
                  f"{len(wavs_h[0])} samples a row; sampler launches "
                  f"{n_launch}")
            assert n_launch > 0
            assert all(len(w_) == HEAD_FRAMES * hop_h and
                       np.isfinite(w_).all() for w_ in wavs_h)
            suffix = "" if dt == "float32" else "_bf16"
            entry = check_head(f"wavenet_sampler_{name}{suffix}", ws, cfg_d,
                               W, wavs_h)
            entry["launches"] = n_launch
            kernels.insert(-1, entry)
        if name == "mol":       # noise suppressed: every draw is mean_0
            quiet = suppress_mol_noise(tree)
            ws = WaveNetSynthesizer(cfg_mol, quiet, device="cuda",
                                    seed=seed, keep_intermediates=True)
            ws.synthesize(mels_h)
            c_q = ws.intermediates["c_up"][:, :W].contiguous()
            n_q = ws.intermediates["noise"][:, :, :W].contiguous()
            q_k = wk.sample(ws.sampler_params, cfg_mol, c_q, n_q,
                            kernel_weights=ws.sampler_kernel)
            q_p = wk.sample_plain(ws.sampler_params, cfg_mol, c_q, n_q)
            q_err = float((q_k - q_p).abs().max())
            print(f"mol, noise suppressed: max |kernel - plain| over the "
                  f"first {W} samples, free run, {q_err:.3e} (samples up "
                  f"to {float(q_p.abs().max()):.3f})")
            assert q_err <= SAMPLER_F32_ATOL, q_err
        done(n, t0)

    # ---- 15. (h) GTA of the r5 train split, then the command line
    kernels.insert(-1, gta_phase(cfg, tparams, stats, seed))

    # ---- 16. (i) Tacotron training at the r5 shapes
    for entry in training_phase(tparams, stats, seed):
        kernels.insert(-1, entry)

    # ---- 17. (j) emt_attn synthesis; 18. (k) the paper preset served
    at = 1 + [k["name"] for k in kernels].index("tacotron_decoder_block")
    kernels[at:at] = emt_phase(texts, gt, tparams, stats, seed, synth, im8)
    paper_phase(held, gt, seed)

    # ---- 19. (l) WaveNet training at the r5 shapes
    kernels.extend(wavenet_training_phase(wparams, seed))

    # ---- 20. (m) the decode kernels' envelope: f32, smoothing
    kernels.extend(envelope_phase(cfg, tparams, stats, prog, texts, gt,
                                  long_texts, out8, seed))

    # ---- 21. (n) the WaveNet stack kernels' envelope: f32, widths
    kernels.extend(stack_envelope_phase(wparams, seed))

    # ---- 22. (o) Griffin-Lim's DFT route; the sampler at B=1, 16, 32
    kernels.append(routes_phase(cfg, prog, batch.astype(np.float32),
                                gl_routes, *smp8, W))

    # ---- 23. (p) the decode at B=1, 9, 16; the sampler's route by width
    rows_phase(cfg, prog, gt, seed)

    # ---- 24. (q) kernel 4a at B=1, 9, 16 and 32, train and eval mode
    train_rows_phase(tparams, stats, seed)

    # ---- 25. (r) kernels 5a and 5b at B=1, 3 and 32; launches a layer
    stack_rows_phase(wparams, seed)

    # ---- 26. (s) the fork's Tacotron training modes on kernels 4a/4b
    variants_phase(tparams, stats, seed, smi)

    # ---- 27. (t) the style discriminators, grafted into training
    disc_phase(seed, smi)

    # ---- 28. (u) the Tacotron variants on their routes
    variant_cases_phase(texts, gt, tparams, stats, seed, smi)

    # ---- 29. (v) the WaveNet variants on their routes; preprocessing
    kernels.extend(wavenet_variants_phase((ids, lengths, refs), gt,
                                          tparams, stats, wparams, seed))

    # ---- 30. (w) data parallelism: nccl at world 1, two gloo ranks
    p30 = dp_phase(tparams, stats, wparams, (ids, lengths, refs, refs),
                   c_w30, seed, smi)
    for entry in kernels:
        if entry["name"] in p30:
            entry["launches_phase30_per_rank"] = p30[entry["name"]]

    # ---- 31. (x) tensor parallelism; the long tail
    p31, gl_bf16 = tail_phase(tparams, stats, wparams,
                              batch.astype(np.float32), cfg, texts, seed,
                              smi)
    for entry in kernels:
        if entry["name"] in p31:
            entry["launches_phase31_per_process"] = p31[entry["name"]]
    kernels.extend(gl_bf16)

    assert all(k["launches"] for k in kernels), kernels
    print(f"total {time.time() - t_start:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
