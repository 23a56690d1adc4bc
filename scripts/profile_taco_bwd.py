"""Where kernel 4b's step goes: the clock cycles of each phase of the
Tacotron BPTT backward (csrc/decoder_bwd.cu built with -DTACO_BWD_PROFILE,
which has thread 0 of the first CTA add up each phase's cycles), in µs a
step, at chip_smoke.py phase 16's shapes (B 16, T_in 96, 448 steps; the r5
weights, the first train batch's memory, kernel 4a's residuals), bf16 and
f32 weights, at the wrapper's cluster size or the one given. Needs one
CUDA device and nvcc:

    python scripts/profile_taco_bwd.py [--cs 8|16]

The phases end at the step's barriers: a phase's time includes its wait for
the slowest warp, and S1-S4 the cluster barriers' waits. The measuring
build keeps more registers live than the kernel the port runs; its total
is within a few percent of the plain build's time.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("load", "proj", "dctx", "dalign partial", "S1", "softmax",
          "elementwise", "de·taps", "conv transpose", "S2", "dq/dcum",
          "wq", "lstm2", "W2", "S3", "lstm1", "W1", "S4", "reductions/da1",
          "prenet", "taps' sum")


def main(argv):
    cs_arg = int(argv[argv.index("--cs") + 1]) if "--cs" in argv else None
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from tacotron2_tpu_torch.convert import load_checkpoints, load_tacotron
    from tacotron2_tpu_torch.eval.convergence import batch_from_rows
    from tacotron2_tpu_torch.models.tacotron.decoder import (
        drop_masks, teacher_inputs, zoneout_masks)
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.native import build
    from tacotron2_tpu_torch.ops import tacotron_decoder_kernel as dk
    from tacotron2_tpu_torch.ops import tacotron_train_kernel as tk

    so = os.path.join(tempfile.mkdtemp(), "decoder_bwd_profile.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                    "-DTACO_BWD_PROFILE", "-o", so,
                    os.path.join(build.CSRC, "decoder_bwd.cu")], check=True,
                   capture_output=True)
    build.build(["decoder"])
    build._libs["decoder_bwd"] = ctypes.CDLL(so)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, dev = cs.train_config(), torch.device("cuda")
    tp, st, _ = load_checkpoints(os.path.join(cs.R5, "taco_ckpt.msgpack"),
                                 os.path.join(cs.R5, "wn_ckpt.msgpack"))
    rows = [("corpus", f"audio-{i}.npy", f"mel-{i}.npy", "", "", "", "", t)
            for i, t in enumerate(cs.corpus_texts())]
    first = batch_from_rows(rows[:cs.TRAIN_BATCH],
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
    ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0]) / 1e3
    scratch = {}
    empty = torch.empty

    def keep_scratch(*a, **k):   # the wrapper's scratch holds the cycles
        x = empty(*a, **k)
        if k.get("dtype") == torch.uint8:
            scratch["x"] = x
        return x

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
        tk.teacher_forced_bwd(*args, kernel_weights=kw, cs=cs_arg)
        torch.empty = keep_scratch
        try:
            ms = cs.cuda_ms(lambda: tk.teacher_forced_bwd(
                *args, kernel_weights=kw, cs=cs_arg), 1)
        finally:
            torch.empty = empty
        cycles = scratch["x"][:8 * len(PHASES)].view(torch.int64).tolist()
        us = {n: round(c / S / (ghz * 1e3), 3) for n, c in zip(PHASES,
                                                                cycles)}
        print(json.dumps({"weights": str(dt).replace("torch.", ""),
                          "cs": cs_arg or tk.bwd_cluster_size(
                              tk.bwd_widths(cfg, kw, memory.shape[2], T)),
                          "ms": ms, "us_a_step": us,
                          "total_us_a_step": round(sum(us.values()), 3)}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
