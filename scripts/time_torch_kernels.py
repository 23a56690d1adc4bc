"""Time the PyTorch port's two CUDA kernels at chip_smoke.py's serving shapes.

    python scripts/time_torch_kernels.py [PORT_ROOT ...]

Each PORT_ROOT is a directory that holds a copy of `tacotron2_tpu_torch/`
(default: this repository), so two versions of the kernels can be timed in
turns on the same GPU (A, B, B, A). For each root, one process: build the
kernels, load the r5 checkpoints, run the memory pass of 8 held-out texts,
then report the median CUDA-event time of 5 runs of the whole decode
(480 steps, early stop per 64-step block), of the decode of 320 steps
without early stop (every version then runs the same row-steps), of one
256-step block from the zero state (the block route's launch), of the
sampler over the first 512 samples (f32, and bf16 cache and weights
where the copy has them), of the mixture-of-logistics (`paper` preset) and
categorical heads over 512 samples of 8 rows on chip_smoke.py's random
weights, f32 and bf16, and (where the copy has it) of
the Griffin-Lim kernel's 60 iterations on the decoded mels (the
`TextToWavProgram(vocoder="griffin_lim")` shape, [8, 480, 1025]), with
checksums of the outputs. Needs one CUDA device.

    python scripts/time_torch_kernels.py --stack [PORT_ROOT ...]

times the WaveNet training stack instead (kernels 5a and 5b, chip_smoke.py
phase 19's shapes: B 16 crops of 8,000 samples of the r5 train split, the
r5 EMA weights): the median of 5 runs of each, in bf16 weights and, where
the copy takes them, f32, with checksums of the outputs (equal checksums
across roots: the same bits).

    python scripts/time_torch_kernels.py --decode [PORT_ROOT ...]

times the decode alone (kernels 1 and 3 on the serve call's inputs) with
bf16 and with f32 decode weights: the median of 5 runs of the 480-step
whole decode, of 320 steps without early stop and of one 256-step block,
with the frames' checksums.

    python scripts/time_torch_kernels.py --bwd [PORT_ROOT ...]

times the Tacotron BPTT backward (kernel 4b) at chip_smoke.py phase 16's
shapes (B 16, T_in 96, 448 steps; the r5 weights and the first train
batch's memory, kernel 4a's residuals, seeded masks and gradients): the
median of 5 runs of the wrapper (with its weight packing) in bf16 and f32
weights, with a checksum of every output both versions write.

    python scripts/time_torch_kernels.py --train-fwd [PORT_ROOT ...]

times the teacher-forced forward (kernel 4a) at the same shapes: its train
mode at B 16 (the first train batch, tfr-0.5 coins, seeded dropout and
zoneout masks) in bf16 and f32 weights, and its eval mode at B 32 (the
first 32 train texts, every coin set, as GTA runs it) in bf16: the median
of 5 runs of the wrapper on weights packed once, with the frames' and
(train mode) the residuals' checksums.
"""

import inspect
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_inputs(root):
    """The r5 serving program of `root`'s port and the memory pass of the
    8 held-out texts: (cfg, the r5 checkpoints, prog, keys, memory, mask,
    dropout multipliers, a generator)."""
    sys.path.insert(0, root)
    sys.path.insert(1, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    import tacotron2_tpu_torch
    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.models.tacotron.decoder import drop_masks
    from tacotron2_tpu_torch.synth.pipeline import TextToWavProgram
    from tacotron2_tpu_torch.text import text_to_sequence

    assert tacotron2_tpu_torch.__file__.startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.r5_config()
    B, dev = len(cs.HELD_ROWS), "cuda"
    tp, st, wp = load_checkpoints(os.path.join(cs.R5, "taco_ckpt.msgpack"),
                                  os.path.join(cs.R5, "wn_ckpt.msgpack"))
    prog = TextToWavProgram(cfg, tp, st, wp, batch=B, steps=cs.MAX_STEPS,
                            t_in=cs.T_IN, device=dev)
    held = cs.held_out_texts()
    seqs = [text_to_sequence(held[i - 128], cfg.data.cleaners)
            for i in cs.HELD_ROWS]
    ids = np.zeros((B, cs.T_IN), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    lens = torch.as_tensor([len(s) for s in seqs], device=dev)
    refs = torch.as_tensor(np.stack([
        np.load(os.path.join(cs.R5, "corpus", "mels", f"mel-{i}.npy"))
        [:cs.T_REF] for i in cs.HELD_ROWS]), device=dev)
    g = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        keys, mem, mask, _, _ = prog.taco.synthesis_memory_ext(
            torch.as_tensor(ids, device=dev), lens, refs, refs)
    drop = drop_masks(cfg, B, cs.MAX_STEPS, g, dev)
    prog.serve_inputs = (ids, lens.cpu().numpy(), refs.cpu().numpy())
    return cfg, (tp, st, wp), prog, keys, mem, mask, drop, g


def time_decode(root):
    """The decode alone (kernels 1 and 3), bf16 and f32 decode weights:
    the 480-step whole decode (early stop per 64-step block), 320 steps
    without early stop and one 256-step block from the zero state, with
    the frames' checksums; and the median of 3 serve calls (the program's
    bf16 sampler), host clock around a synchronised call."""
    cfg, (tp, _, _), prog, keys, mem, mask, drop, _ = _serve_inputs(root)
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    B, T, M = mem.shape
    K = cfg.tacotron.early_stop_block
    out = {"root": root}
    with torch.no_grad():
        for wd in ("bfloat16", "float32"):
            cfg_w = cfg.with_overrides(f"tacotron.fused_decoder_dtype={wd}")
            dp = dk.extract_decoder_params(tp, cfg_w, device="cuda")
            kw = dk.pack_weights(dp)
            st0 = dk.init_decoder_state(cfg_w, B, T, M, "cuda")
            runs = {
                "": lambda: dk.decode(dp, cfg_w, keys, mem, mask, drop,
                                      steps=cs.MAX_STEPS, early_stop_block=K,
                                      emit_alignments=False,
                                      kernel_weights=kw),
                "_320_steps_no_early_stop": lambda: dk.decode(
                    dp, cfg_w, keys, mem, mask, drop[:, :320].contiguous(),
                    steps=320, early_stop_block=0, emit_alignments=False,
                    kernel_weights=kw),
                "_block_256_steps": lambda: dk.decode_block(
                    dp, cfg_w, keys, mem, mask, st0,
                    drop[:, :256].contiguous(), kernel_weights=kw)}
            for name, fn in runs.items():
                out[f"decoder_{wd}{name}_sum"] = float(fn()[0].sum())
                out[f"decoder_{wd}{name}_ms"] = cs.cuda_ms(fn, 5)
    serve = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.time()
        prog(*prog.serve_inputs, prog.serve_inputs[2])
        torch.cuda.synchronize()
        serve.append(time.time() - t0)
    out["serve_s"] = float(np.median(serve[1:]))   # the first warms up
    print(json.dumps(out), flush=True)


def time_one(root):
    cfg, _, prog, keys, mem, mask, drop, g = _serve_inputs(root)
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import wavenet_kernel as wk
    B, dev = len(cs.HELD_ROWS), "cuda"
    W, K = cs.SAMPLER_WINDOW, cfg.tacotron.early_stop_block
    with torch.no_grad():
        dec = lambda: dk.decode(prog.dec_params, cfg, keys, mem, mask, drop,
                                steps=cs.MAX_STEPS, early_stop_block=K,
                                kernel_weights=prog.dec_kernel)
        # versions that can return alignments are asked not to
        no_align = ({"emit_alignments": False} if "emit_alignments" in
                    inspect.signature(dk.decode).parameters else {})
        drop320 = drop[:, :320].contiguous()
        dec320 = lambda: dk.decode(prog.dec_params, cfg, keys, mem, mask,
                                   drop320, steps=320, early_stop_block=0,
                                   kernel_weights=prog.dec_kernel, **no_align)
        st0 = dk.init_decoder_state(cfg, B, keys.shape[1], mem.shape[2], dev)
        drop256 = drop[:, :256].contiguous()
        blk256 = lambda: dk.decode_block(prog.dec_params, cfg, keys, mem,
                                         mask, st0, drop256,
                                         kernel_weights=prog.dec_kernel)
        frames = dec()[0]   # (frames, stops[, alignments])
        _, mel = prog.taco.postnet_pass(frames)
        c = (torch.clamp(mel, -4.0, 4.0) + 4.0) / 8.0
        c_up = prog.wavenet.upsample(c)[:, :W].contiguous()
        z = torch.randn(B, W, generator=g, device=dev)
        sp = prog.sampler_params
        # the f32 sampler, and the bf16 one in versions that have it
        samplers = {"": wk.pack_weights(sp, cfg)}
        if "weight_dtype" in inspect.signature(wk.pack_weights).parameters:
            bf = torch.bfloat16
            samplers["_bf16"] = wk.pack_weights(sp, cfg, cache_dtype=bf,
                                                weight_dtype=bf)
        smp = {k: (lambda kw=kw: wk.sample(sp, cfg, c_up, z,
                                           kernel_weights=kw))
               for k, kw in samplers.items()}
        # the other heads on random weights (chip_smoke.py's), f32 and bf16
        from tacotron2_tpu_torch.config import get_config
        from tacotron2_tpu_torch.models.wavenet.distributions import \
            draw_noise
        from tacotron2_tpu_torch.models.wavenet.sampler import \
            extract_sampler_params
        for name, cfg_h in (
                ("mol", get_config("paper")),
                ("categorical", get_config(
                    "default", "wavenet.input_type=mulaw-quantize,"
                    "wavenet.quantize_channels=256,wavenet.out_channels=256"))):
            sp_h = extract_sampler_params(cs.random_wavenet_tree(cfg_h,
                                                                 cs.SEED),
                                          cfg_h, device=dev)
            g_h = torch.Generator(dev).manual_seed(1)
            c_h = torch.rand(B, W, cfg_h.wavenet.cin_channels, generator=g_h,
                             device=dev)
            n_h = draw_noise(cfg_h, B, W, g_h, dev)
            for dt, suf in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
                kw_h = wk.pack_weights(sp_h, cfg_h, cache_dtype=dt,
                                       weight_dtype=dt)
                smp[f"_{name}{suf}"] = (
                    lambda sp_h=sp_h, cfg_h=cfg_h, c_h=c_h, n_h=n_h,
                    kw_h=kw_h: wk.sample(sp_h, cfg_h, c_h, n_h,
                                         kernel_weights=kw_h))
        y = {k: float(f().sum()) for k, f in smp.items()}
        torch.cuda.synchronize()
        gl_ms = gl_sum = None
        if os.path.exists(os.path.join(root, "tacotron2_tpu_torch", "ops",
                                       "griffin_lim_kernel.py")):
            from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
            a = cfg.audio
            S = cs.gl_magnitudes(mel, a, dev)
            zeros = torch.zeros_like(S)
            gl = lambda: glk.fused_griffin_lim(
                S, S, zeros, a.n_fft, a.effective_hop, a.win_size,
                a.griffin_lim_iters)
            gl_sum = float(gl().sum())
            gl_ms = cs.cuda_ms(gl, 3)
        out = {"root": root, "decoder_ms": cs.cuda_ms(dec, 5),
               "decoder_ms_320_steps_no_early_stop": cs.cuda_ms(dec320, 5),
               "decoder_block_ms_256_steps": cs.cuda_ms(blk256, 5),
               **{f"sampler_ms_{W}{k}": cs.cuda_ms(f, 5)
                  for k, f in smp.items()},
               "frames_sum": float(frames.sum()),
               **{f"samples_sum{k}": v for k, v in y.items()},
               "griffin_lim_ms_60_iters": gl_ms, "griffin_lim_sum": gl_sum}
    print(json.dumps(out), flush=True)


def time_stack(root):
    sys.path.insert(0, root)
    sys.path.insert(1, REPO)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    import tacotron2_tpu_torch
    from tacotron2_tpu_torch import convert
    from tacotron2_tpu_torch.convert import load_checkpoints
    from tacotron2_tpu_torch.models.wavenet.modules import round_bf16
    from tacotron2_tpu_torch.ops import wavenet_train_kernel as wtk
    from tacotron2_tpu_torch.train.wavenet_step import WaveNetTrainer

    assert tacotron2_tpu_torch.__file__.startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dev = cs.r5_config(), torch.device("cuda")
    _, _, wp = load_checkpoints(os.path.join(cs.R5, "taco_ckpt.msgpack"),
                                os.path.join(cs.R5, "wn_ckpt.msgpack"))
    B, F = len(cs.WN_ROWS), cs.WN_CROP_FRAMES
    pairs = cs.r5_wavenet_rows(os.path.join(cs.R5, "corpus"), cs.WN_ROWS)
    rng = np.random.default_rng(cs.SEED)
    batch = cs.wavenet_batch(pairs, [int(rng.integers(0, len(m) - F + 1))
                                     for _, m in pairs])
    model = convert.wavenet_from_flax(cfg, wp, dev, trainable=True)
    b = WaveNetTrainer(cfg).batch_to_device(batch)
    with torch.no_grad():
        c_up = model.upsample(b["c"])
        x0 = model.input_convolution(round_bf16(b["x"]), round_bf16)
    T = x0.shape[1]
    x2 = x0.transpose(0, 1).reshape(T * B, -1).contiguous()
    c2 = round_bf16(c_up).transpose(0, 1).reshape(T * B, -1).contiguous()
    sp = wtk.StackParams(*(t.detach() for t in wtk.extract_stack_params(
        model.residual_blocks, cfg)))
    g = torch.Generator(dev).manual_seed(0)
    dskip = torch.randn(T * B, cfg.wavenet.skip_out_channels, generator=g,
                        device=dev) * 1e-3
    out = {"root": root}
    for dt in ("bfloat16", "float32"):
        plan = wtk.make_plan(cfg.replace(wavenet=dataclasses.replace(
            cfg.wavenet, compute_dtype=dt)), B)
        try:
            ks, ka = wtk.stack_fwd_cuda(plan, sp, x2, c2, cs.SEED)
        except ValueError:      # a copy that takes bf16 weights only
            continue
        kb = wtk.stack_bwd_cuda(plan, sp, ka, c2, dskip, cs.SEED)
        torch.cuda.synchronize()
        out[f"fwd_ms_{dt}"] = cs.cuda_ms(
            lambda: wtk.stack_fwd_cuda(plan, sp, x2, c2, cs.SEED), 5)
        out[f"bwd_ms_{dt}"] = cs.cuda_ms(
            lambda: wtk.stack_bwd_cuda(plan, sp, ka, c2, dskip, cs.SEED), 5)
        out[f"skip_sum_{dt}"] = float(ks.double().sum())
        out[f"grad_sum_{dt}"] = float(sum(t.double().sum()
                                          for t in [*kb[0], kb[1], kb[2]]))
    print(json.dumps(out), flush=True)


def _train_inputs(root, n_rows):
    """`root`'s port with the r5 checkpoints at chip_smoke.py phase 16's
    shapes: (cfg, the f32 DecoderParams, keys, memory, mask, teacher,
    tfr-0.5 coins, dropout and zoneout masks) of the first n_rows train
    texts."""
    sys.path.insert(0, root)
    sys.path.insert(1, REPO)
    import torch

    import chip_smoke as cs
    import tacotron2_tpu_torch
    from tacotron2_tpu_torch.convert import load_checkpoints, load_tacotron
    from tacotron2_tpu_torch.eval.convergence import batch_from_rows
    from tacotron2_tpu_torch.models.tacotron.decoder import (
        drop_masks, teacher_inputs, zoneout_masks)
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk

    assert tacotron2_tpu_torch.__file__.startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, dev = cs.train_config(), torch.device("cuda")
    tp, st, _ = load_checkpoints(os.path.join(cs.R5, "taco_ckpt.msgpack"),
                                 os.path.join(cs.R5, "wn_ckpt.msgpack"))
    rows = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
            for i, t in enumerate(cs.corpus_texts())]
    first = batch_from_rows(rows[:n_rows],
                            os.path.join(cs.R5, "corpus", "mels"), cfg,
                            pad_text_to=cs.PAD_TEXT, pad_mel_to=cs.PAD_MEL)
    model = load_tacotron(Tacotron(cfg), tp, st).to(dev)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in first.items()}
    r = cfg.tacotron.outputs_per_step
    with torch.no_grad():
        keys, memory, mask, _, _ = model.synthesis_memory_ext(
            tb["inputs"], tb["input_lengths"], tb["ref_mel_emt"],
            tb["ref_mel_spk"])
        dp32 = tk.extract_params_traced(model.decoder, cfg)
    B, T, _ = memory.shape
    S = cs.PAD_MEL // r
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    teacher = teacher_inputs(tb["mel_targets"], r)
    coins = (torch.rand(S, generator=g, device=dev) < 0.5).to(torch.int32)
    drop = drop_masks(cfg, B, S, g, dev)
    zmask = zoneout_masks(cfg, B, S, g, dev)
    return cfg, dp32, keys, memory, mask, teacher, coins, drop, zmask


def time_bwd(root):
    cfg, dp32, keys, memory, mask, teacher, coins, drop, zmask = \
        _train_inputs(root, 16)
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    B, T, _ = memory.shape
    S = teacher.shape[0]
    names = ("dz1", "dz2", "da0", "da1", "dproj", "dctx", "dq", "dkeys",
             "dwp", "dva")
    out = {"root": root}
    for dt in (torch.bfloat16, torch.float32):
        with torch.no_grad():
            dp = tk.cast_params(dp32, dt)
        kw = dk.pack_weights(dp)
        res = tk.teacher_forced_train_fwd(dp, cfg, keys, memory, mask,
                                          teacher, coins, drop, zmask,
                                          kernel_weights=kw)[3]
        gd = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
        dout = torch.randn(B, S, res["out"].shape[-1], generator=gd,
                           device=dev) * 1e-3
        dalign = torch.randn(B, S, T, generator=gd, device=dev) * 1e-3
        args = (dp, cfg, res, keys, memory, mask, coins, drop, zmask, dout,
                dalign)
        k = tk.teacher_forced_bwd(*args, kernel_weights=kw)
        torch.cuda.synchronize()
        name = str(dt).replace("torch.", "")
        out[f"bwd_ms_{name}"] = cs.cuda_ms(
            lambda: tk.teacher_forced_bwd(*args, kernel_weights=kw), 5)
        out[f"bwd_sum_{name}"] = float(sum(k[n].double().abs().sum()
                                           for n in names))
    print(json.dumps(out), flush=True)


def time_train_fwd(root):
    """Kernel 4a: the train mode at B 16 in bf16 and f32 weights, the eval
    mode at B 32 (every coin set) in bf16."""
    cfg, dp32, keys, memory, mask, teacher, coins, drop, zmask = \
        _train_inputs(root, 32)
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk
    b16 = slice(0, cs.TRAIN_BATCH)
    out = {"root": root}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).replace("torch.", "")
        with torch.no_grad():
            dp = tk.cast_params(dp32, dt)
        kw = dk.pack_weights(dp)
        train = (dp, cfg, keys[b16], memory[b16], mask[b16],
                 teacher[:, b16].contiguous(), coins, drop[b16], zmask[b16])
        k = tk.teacher_forced_train_fwd(*train, kernel_weights=kw)
        torch.cuda.synchronize()
        out[f"train_fwd_ms_{name}"] = cs.cuda_ms(
            lambda: tk.teacher_forced_train_fwd(*train, kernel_weights=kw), 5)
        out[f"train_fwd_sum_{name}"] = float(
            k[0].double().abs().sum() + sum(k[3][n].double().abs().sum()
                                            for n in tk.RES_NAMES))
        if dt == torch.bfloat16:
            ones = torch.ones_like(coins)
            ev = (dp, cfg, keys, memory, mask, teacher, ones, drop)
            f = tk.teacher_forced_fwd(*ev, kernel_weights=kw)[0]
            torch.cuda.synchronize()
            out["eval_fwd_ms_bfloat16_b32"] = cs.cuda_ms(
                lambda: tk.teacher_forced_fwd(*ev, kernel_weights=kw), 5)
            out["eval_fwd_sum_bfloat16_b32"] = float(f.double().abs().sum())
        del k
    print(json.dumps(out), flush=True)


def main(argv):
    modes = {"--one": time_one, "--one-stack": time_stack,
             "--one-bwd": time_bwd, "--one-decode": time_decode,
             "--one-train-fwd": time_train_fwd}
    if len(argv) == 2 and argv[0] in modes:
        modes[argv[0]](os.path.abspath(argv[1]))
        return 0
    mode = "--one"
    if argv[:1] in (["--stack"], ["--bwd"], ["--decode"], ["--train-fwd"]):
        mode, argv = f"--one-{argv[0][2:]}", argv[1:]
    for root in argv or [REPO]:
        subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
