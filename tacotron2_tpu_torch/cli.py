"""Command line of the PyTorch port: `python -m tacotron2_tpu_torch.cli
preprocess | wavenet-preprocess | create-metadata | vctk-accent-relabel |
serve | synthesize | train | disc-train | emt-disc-train | disc-preprocess
| disc-test | fixed-eval-set`.

The preprocessing commands, ports of tacotron2_tpu/cli.py (:41-71,
:504-544) over `data/preprocess.py`, run on the host (`--n-jobs` spawned
workers, or `--serial`): `create-metadata` writes a corpus manifest
`path|text|emt|spk|sex` (--layout ljspeech, folders, emt4, jessa, emth,
librispeech or vctk); `preprocess` turns it (--metadata, else
<in-dir>/metadata_<dataset>.txt) into <out-dir>/<dataset>/mels (with
--write-audio the audio, with --write-linear the linear spectrograms) and
<out-dir>/train.txt; `wavenet-preprocess` turns a folder of wavs into
<out-dir>/audio and mels and the map.txt that `train --model WaveNet`
reads; `vctk-accent-relabel` rewrites a VCTK train.txt's emotion column
with accent ids.

`serve`, port of tacotron2_tpu/cli.py `serve` (:382): text → wav through
one `TextToWavProgram` per padded-text bucket, built on first use and
cached; `--vocoder griffin_lim` swaps WaveNet for Griffin-Lim. Sentences
come from --text-list / --sentence, or from stdin, one per line; wavs land
in <output-dir>/serve/speech-NNNNN.wav.

`synthesize`, port of cli.py `synthesize` (:232-298):
- `--model Tacotron`, by `--mode`:
  - `eval` (the default): sentences (--text-list / --sentence, else the
    reference's eval sentences) → `TacotronSynthesizer` → mels, map.txt
    and Griffin-Lim wavs under <output-dir>/eval/;
  - `gta`: the train.txt rows of --input-path (--limit rows), teacher-
    forced on their own mels → <output-dir>/gta/mels and map.txt;
  - `synthesis`: each row of --synth-metadata (else --input-path) with
    its emotion and speaker references, resolved under --input-dir (else
    the metadata's directory), swapped by --flip-spk-emt →
    <output-dir>/natural/;
  - `synthesis_random` (--paired), `synthesis_multiple` (--flip-spk-emt)
    and `style_embs` (--n-spk, --n-per-spk) on the train.txt of
    --input-path → <output-dir>/random/, multiple/, embeddings/;
- `--model WaveNet`: the mels a map.txt names (--mels-map, else
  <output-dir>/gta/map.txt with --mode gta and <output-dir>/eval/map.txt
  otherwise; --limit rows) → `WaveNetSynthesizer` →
  <output-dir>/wavenet/wavs/wavenet-<mel name>.wav, in batches of
  `train.wavenet_synthesis_batch_size`;
- `--model Tacotron-2` (the default, as in the reference): the first, then
  the second on the map.txt it wrote; after `synthesis_random`,
  `synthesis_multiple` and `style_embs` it stops before WaveNet, as the
  JAX command does.

`train`, port of cli.py `train` (:73, :111-175), logging and
checkpointing under <base-dir>/logs-<model>:
- `--model Tacotron`: the Tacotron trainer (`train/tacotron_train.py`) on
  the train.txt of --input-path (checkpoints in taco_pretrained/, the
  curve in taco_curve.jsonl), with the fork's training flags, which reach
  the feeder and the trainer as the JAX command passes them (`--emt-only`,
  `--intercross-both`, `--unpaired`, `--adv-emb-disc`, `--nat-gan`,
  `--opt-ref-no-mo`, `--pretrained-emb-disc(-all)`, `--remove-long-samps`,
  `--test-inputs`, `--test-max-len`); `--pretrained-disc-emt/-spk`
  graft a discriminator (a `disc-train` checkpoint directory or a
  reference TF checkpoint) into `pretrained_ref_enc_{emt,spk}`,
  `--save-output-vars` dumps the eval forward's tensors as CSVs under
  output_vars/;
- `--model WaveNet`: the vocoder trainer (`train/wavenet_train.py`) on a
  GTA map.txt (or a train.txt with --no-gta) of (audio, mel) pairs
  (checkpoints in wave_pretrained/, which `synthesize
  --wavenet-checkpoint` reads, the curve in wavenet_curve.jsonl);
- `--model Tacotron-2`: the sequencer: Tacotron training, GTA synthesis
  of the train.txt into <base-dir>/tacotron_output/gta/, then WaveNet
  training on its map.txt (--wavenet-train-steps, --wavenet-batch-size),
  resumable through <base-dir>/state_log;
- under `torchrun --nproc_per_node N -m tacotron2_tpu_torch.cli train
  ...` one data-parallel rank a card (`parallel/dist.py`): each steps on
  batch_size / N rows of one global batch, rank 0 alone writes;
- every model: train.log in the log directory (`--slack-url` posts the
  run's milestones, `--verbose` logs the whole config), metrics.jsonl,
  and with `--profile-start N [--profile-end M]` a torch.profiler trace
  of the steps between under profile/.

The style discriminators (`disc/`, JAX cli.py:447-497, 642-697):
`disc-train` (an emotion, speaker or accent discriminator on a train.txt,
or on `disc-preprocess`'s TI-SV stacks with --stacks-dir; CE head or
GE2E; checkpoints in <base-dir>/disc_<kind>/), `emt-disc-train` (the
standalone emotion classifier, <base-dir>/emt_disc/), `disc-preprocess`
(<corpus>/<speaker>/**/*.wav -> per-speaker log-mel window stacks),
`disc-test` (classify a synthesis map.txt's or a train.txt's mels: the
accuracy, disc_test_<kind>.csv and confusion_<kind>.png) and
`fixed-eval-set` (a style-transfer eval manifest from a train.txt).

Weights are the JAX package's flax msgpack checkpoints (Tacotron
{params, batch_stats}, WaveNet EMA params), read without flax; reference
mels are `.npy` files. Every command that puts tensors on a device runs
on `--device` (default cuda); `disc-preprocess` and `fixed-eval-set` run
on the host.

    python -m tacotron2_tpu_torch.cli serve \
        --checkpoint artifacts/e2e_demo_r5/taco_ckpt.msgpack \
        --wavenet-checkpoint artifacts/e2e_demo_r5/wn_ckpt.msgpack \
        --ref-mel-emt ref.npy --sentence "abcdefg hij"
    python -m tacotron2_tpu_torch.cli synthesize --model Tacotron \
        --mode eval --checkpoint artifacts/e2e_demo_r5/taco_ckpt.msgpack \
        --ref-mel-emt ref.npy --text-list texts.txt --output-dir out
    python -m tacotron2_tpu_torch.cli synthesize --model Tacotron-2 \
        --checkpoint artifacts/e2e_demo_r5/taco_ckpt.msgpack \
        --wavenet-checkpoint artifacts/e2e_demo_r5/wn_ckpt.msgpack \
        --ref-mel-emt ref.npy --text-list texts.txt --output-dir out
    python -m tacotron2_tpu_torch.cli synthesize --model Tacotron-2 \
        --mode gta --input-path data/train.txt --limit 8 \
        --checkpoint artifacts/e2e_demo_r5/taco_ckpt.msgpack \
        --wavenet-checkpoint artifacts/e2e_demo_r5/wn_ckpt.msgpack \
        --output-dir out
    python -m tacotron2_tpu_torch.cli train --model Tacotron \
        --input-path data/train.txt --base-dir runs --train-steps 1000
    python -m tacotron2_tpu_torch.cli train --model WaveNet \
        --input-path runs/tacotron_output/gta/map.txt --base-dir runs
    python -m tacotron2_tpu_torch.cli disc-train --kind emt \
        --loss-type ce --input-path data/train.txt --base-dir runs
    python -m tacotron2_tpu_torch.cli train --model Tacotron \
        --input-path data/train.txt --base-dir runs --unpaired \
        --pretrained-emb-disc --pretrained-disc-emt runs/disc_emt \
        --pretrained-disc-spk runs/disc_spk
    python -m tacotron2_tpu_torch.cli disc-test --kind emt \
        --checkpoint runs/disc_emt --map-path out/natural/map.txt
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from .config import get_config
from .data.audio import save_wav
from .utils import infolog_init, log


def make_serve_fn(args):
    """Returns (run, out_dir): run(sentences) synthesizes through the
    bucketed programs and returns the written wav paths."""
    from .convert import load_checkpoints
    from .synth.pipeline import TextToWavProgram
    from .text import text_to_sequence

    cfg = get_config(args.preset, args.hparams)
    out_dir = os.path.join(args.output_dir, "serve")
    os.makedirs(out_dir, exist_ok=True)
    if args.vocoder == "wavenet" and not args.wavenet_checkpoint:
        raise SystemExit("serve --vocoder wavenet needs --wavenet-checkpoint")
    tparams, stats, wparams = load_checkpoints(args.checkpoint,
                                               args.wavenet_checkpoint)
    nm = cfg.audio.num_mels
    ref = (np.load(args.ref_mel_emt) if args.ref_mel_emt
           else np.zeros((args.t_ref, nm), np.float32))
    ref_spk = np.load(args.ref_mel_spk) if args.ref_mel_spk else ref
    buckets = sorted(int(b) for b in args.buckets.split(","))
    programs = {}

    def program_for(seq_len: int) -> TextToWavProgram:
        t_in = next((b for b in buckets if b >= seq_len), None)
        if t_in is None:
            raise ValueError(f"cleaned text length {seq_len} exceeds largest "
                             f"bucket {buckets[-1]} (raise --buckets)")
        if t_in not in programs:
            t0 = time.time()
            programs[t_in] = TextToWavProgram(
                cfg, tparams, stats, wparams, batch=args.serve_batch,
                steps=args.steps, t_in=t_in, t_ref=args.t_ref,
                device=args.device, seed=args.seed, vocoder=args.vocoder)
            log(f"serve: built bucket t_in={t_in} batch={args.serve_batch} "
                f"steps={args.steps} in {time.time() - t0:.1f}s")
        return programs[t_in]

    counter = [len(glob.glob(os.path.join(out_dir, "speech-*.wav")))]

    def run(sentences):
        seq_len = max(len(text_to_sequence(s, cfg.data.cleaners))
                      for s in sentences)
        prog = program_for(seq_len)
        refs = [ref[:args.t_ref]] * len(sentences)
        refs_s = [ref_spk[:args.t_ref]] * len(sentences)
        t0 = time.time()
        wavs = prog.synthesize(sentences, refs, refs_s)
        dt = time.time() - t0
        paths = []
        for w in wavs:
            path = os.path.join(out_dir, f"speech-{counter[0]:05d}.wav")
            save_wav(w, path, cfg.audio.sample_rate)
            paths.append(path)
            counter[0] += 1
        audio_s = sum(len(w) for w in wavs) / cfg.audio.sample_rate
        log(f"serve: {len(wavs)} utts in {dt:.2f}s "
            f"({audio_s / max(dt, 1e-9):.2f}x realtime) -> {out_dir}")
        return paths

    return run, out_dir


def cmd_serve(args):
    run, _ = make_serve_fn(args)
    if args.text_list or args.sentence:
        run(_sentences(args))
    else:
        for line in sys.stdin:
            if not line.strip():
                break
            run([line.strip()])


def _sentences(args):
    if args.text_list:
        with open(args.text_list, encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]
    if args.sentence:
        return [args.sentence]
    from .data.eval_sentences import EVAL_SENTENCES
    return list(EVAL_SENTENCES)


# the modes whose output WaveNet does not vocode (JAX cli.py:286-288)
EXPORT_MODES = ("synthesis_random", "synthesis_multiple", "style_embs")


def _run_tacotron_mode(synth, args, out_dir: str) -> str:
    """One Tacotron-stage mode; returns its map.txt or output directory."""
    from .synth import tacotron_synth as ts

    input_dir = args.input_dir or os.path.dirname(args.input_path or "")
    if args.mode != "eval" and not (args.input_path or (
            args.mode == "synthesis" and args.synth_metadata)):
        raise SystemExit(f"synthesize --mode {args.mode} needs --input-path")
    if args.mode == "gta":
        return ts.run_gta_synthesis(synth, args.input_path, out_dir,
                                    limit=args.limit)
    if args.mode == "synthesis":
        return ts.run_style_transfer(
            synth, args.synth_metadata or args.input_path, input_dir,
            out_dir, flip_spk_emt=args.flip_spk_emt, limit=args.limit)
    if args.mode == "synthesis_random":
        return ts.run_synthesis_random(synth, args.input_path, input_dir,
                                       out_dir, paired=args.paired)
    if args.mode == "synthesis_multiple":
        return ts.run_synthesis_multiple(synth, args.input_path, input_dir,
                                         out_dir,
                                         flip_spk_emt=args.flip_spk_emt)
    if args.mode == "style_embs":
        return ts.run_style_embs(synth, args.input_path, input_dir, out_dir,
                                 n_spk=args.n_spk, n_per_spk=args.n_per_spk)
    cfg = synth.cfg
    ref = (np.load(args.ref_mel_emt) if args.ref_mel_emt
           else np.zeros((40, cfg.audio.num_mels), np.float32))
    ref_spk = np.load(args.ref_mel_spk) if args.ref_mel_spk else ref
    sentences = _sentences(args)
    return ts.run_eval(synth, sentences, [ref] * len(sentences),
                       [ref_spk] * len(sentences), out_dir)


def cmd_synthesize(args):
    """Returns the map.txt path (or the output directory) of the Tacotron
    stage for --model Tacotron and the export modes, else the paths of the
    WaveNet wavs."""
    vocode = args.model == "WaveNet" or (args.model == "Tacotron-2"
                                         and args.mode not in EXPORT_MODES)
    if vocode and not args.wavenet_checkpoint:
        raise SystemExit(f"synthesize --model {args.model} needs "
                         "--wavenet-checkpoint")
    from . import convert

    cfg = get_config(args.preset, args.hparams)
    if args.model in ("Tacotron", "Tacotron-2"):
        from .synth.tacotron_synth import TacotronSynthesizer

        if not args.checkpoint:
            raise SystemExit(f"synthesize --model {args.model} needs "
                             "--checkpoint")
        tparams, stats, _ = convert.load_checkpoints(args.checkpoint)
        t0 = time.time()
        synth = TacotronSynthesizer(cfg, tparams, stats, device=args.device,
                                    seed=args.seed)
        out = _run_tacotron_mode(synth, args, args.output_dir)
        log(f"tacotron synthesis --mode {args.mode} in "
            f"{time.time() - t0:.2f}s -> {out}")
        if args.model == "Tacotron" or args.mode in EXPORT_MODES:
            return out
    from .synth.wavenet_synth import WaveNetSynthesizer, run_synthesis

    map_path = args.mels_map or os.path.join(
        args.output_dir, "gta" if args.mode == "gta" else "eval", "map.txt")
    t0 = time.time()
    synth_wn = WaveNetSynthesizer(
        cfg, convert.load_wavenet(args.wavenet_checkpoint),
        device=args.device, seed=args.seed)
    wav_out = os.path.join(args.output_dir, "wavenet")
    paths = run_synthesis(synth_wn, map_path, wav_out, limit=args.limit)
    log(f"wavenet synthesis: {len(paths)} wavs in {time.time() - t0:.2f}s "
        f"-> {wav_out}")
    return paths


TRAIN_FLAGS = ("emt-only", "intercross-both", "unpaired", "adv-emb-disc",
               "nat-gan", "opt-ref-no-mo", "pretrained-emb-disc",
               "pretrained-emb-disc-all", "remove-long-samps", "test-inputs",
               "test-max-len")


STATE_ORDER = ("taco", "GTA", "wave")


def save_seq(path: str, completed) -> None:
    """The Tacotron-2 sequencer's stage file (reference train.py:16-22)."""
    with open(path, "w") as f:
        f.write(" ".join("1" if s in completed else "0" for s in STATE_ORDER))


def read_seq(path: str) -> set:
    if os.path.exists(path):
        with open(path) as f:
            flags = f.read().split()
        return {s for s, fl in zip(STATE_ORDER, flags) if fl == "1"}
    return set()


def cmd_train(args):
    """Train Tacotron, WaveNet, or both with GTA synthesis between; returns
    the last stage's checkpoint directory. Under torchrun's env the
    data-parallel group starts first (JAX cli.py:73-78), one rank a card
    (`--dist-backend`: nccl by default on the card, gloo on the CPU or
    for ranks that share a card); rank 0 alone writes train.log."""
    from .parallel import dist
    cfg = get_config(args.preset, args.hparams)
    dp = dist.maybe_initialize_distributed(args.dist_backend, args.device,
                                           cfg.mesh)
    log_dir = os.path.join(args.base_dir, f"logs-{args.model}")
    if dist.is_chief():
        os.makedirs(log_dir, exist_ok=True)
        infolog_init(os.path.join(log_dir, "train.log"), args.model,
                     args.slack_url)
    if dp is not None:
        args.device = str(dp.device)
        log(f"Data-parallel group: rank {dp.rank} of {dp.world} on "
            f"{dp.device} ({args.dist_backend or 'default'} backend)")
    log(cfg.debug_string() if args.verbose else
        f"Training {args.model} on {args.device}")
    if args.model == "Tacotron":
        return _train_tacotron(cfg, args, log_dir)
    if args.model == "WaveNet":
        return _train_wavenet(cfg, args, log_dir, args.input_path,
                              args.train_steps, args.batch_size,
                              gta=not args.no_gta)
    return _train_sequencer(cfg, args, log_dir)


def feeder_kwargs(args) -> dict:
    """The feeder's options of the train flags (JAX cli.py:88-93)."""
    return dict(emt_only=args.emt_only,
                intercross_both=args.intercross_both,
                unpaired=args.unpaired,
                remove_long_samples=args.remove_long_samps,
                test_inputs=args.test_inputs,
                test_max_len=args.test_max_len)


def trainer_kwargs(args) -> dict:
    """The trainer's flags of the train flags (JAX cli.py:94-98)."""
    return dict(emt_only=args.emt_only, adv_emb_disc=args.adv_emb_disc,
                nat_gan=args.nat_gan, use_unpaired=args.unpaired,
                opt_ref_no_mo=args.opt_ref_no_mo,
                pretrained_emb_disc=args.pretrained_emb_disc,
                pretrained_emb_disc_all=args.pretrained_emb_disc_all)


def _train_tacotron(cfg, args, log_dir):
    from .train.tacotron_train import tacotron_train
    ckpt_dir, _ = tacotron_train(
        cfg, args.input_path, log_dir, train_steps=args.train_steps,
        restore=args.restore, batch_size=args.batch_size,
        device=args.device, checkpoint_interval=args.checkpoint_interval,
        eval_interval=args.eval_interval, feeder_kwargs=feeder_kwargs(args),
        trainer_kwargs=trainer_kwargs(args),
        pretrained_disc_emt=args.pretrained_disc_emt,
        pretrained_disc_spk=args.pretrained_disc_spk,
        save_output_vars=args.save_output_vars,
        profile_start=args.profile_start, profile_end=args.profile_end)
    return ckpt_dir


def _train_wavenet(cfg, args, log_dir, input_path, steps, batch_size, gta):
    from .train.wavenet_train import wavenet_train
    ckpt_dir, _ = wavenet_train(
        cfg, input_path, log_dir, train_steps=steps, restore=args.restore,
        gta=gta, batch_size=batch_size, device=args.device,
        checkpoint_interval=args.checkpoint_interval,
        eval_interval=args.eval_interval, profile_start=args.profile_start,
        profile_end=args.profile_end)
    return ckpt_dir


def _train_sequencer(cfg, args, log_dir):
    """Tacotron training -> GTA synthesis -> WaveNet training (reference
    train.py:43-90), each stage recorded in <base-dir>/state_log so that
    a rerun resumes after the last finished one. Under a data-parallel
    group both trainings run on every rank; rank 0 alone runs the GTA
    synthesis and writes the state_log, and the others wait for it."""
    from .synth.tacotron_synth import TacotronSynthesizer, run_gta_synthesis
    from .train.checkpoint import CheckpointManager
    from .parallel import dist
    from .utils import flax_msgpack

    chief = dist.is_chief()
    state_path = os.path.join(args.base_dir, "state_log")
    done = read_seq(state_path)
    out_dir = os.path.join(args.base_dir, "tacotron_output")
    taco_dir = os.path.join(log_dir, "taco_pretrained")
    if "taco" not in done:
        log("Tacotron Train")
        taco_dir = _train_tacotron(cfg, args, log_dir)
        done.add("taco")
        if chief:
            save_seq(state_path, done)
    if "GTA" not in done and chief:
        log("GTA Synthesis")
        mgr = CheckpointManager(taco_dir)
        tree = flax_msgpack.load(mgr.path(mgr.latest_step()))
        synth = TacotronSynthesizer(cfg, tree["params"], tree["batch_stats"],
                                    device=args.device,
                                    emt_only=args.emt_only,
                                    pretrained_emb_disc_all=(
                                        args.pretrained_emb_disc_all))
        run_gta_synthesis(synth, args.input_path, out_dir,
                          batch_size=args.batch_size or 32)
        done.add("GTA")
        save_seq(state_path, done)
    dist.barrier()                  # the GTA map.txt is written
    ckpt_dir = os.path.join(log_dir, "wave_pretrained")
    if "wave" not in done:
        log("WaveNet Train")
        ckpt_dir = _train_wavenet(
            cfg, args, log_dir, os.path.join(out_dir, "gta", "map.txt"),
            args.wavenet_train_steps or args.train_steps,
            args.wavenet_batch_size, gta=True)
        done.add("wave")
        if chief:
            save_seq(state_path, done)
    log("Tacotron-2 pipeline complete", slack=True)
    return ckpt_dir


def cmd_disc_train(args):
    """Returns the checkpoint directory."""
    from .disc.train import disc_train
    cfg = get_config(args.preset, args.hparams)
    ckpt_dir, _ = disc_train(
        cfg, args.input_path, args.base_dir, kind=args.kind,
        train_steps=args.train_steps, n_per_class=args.n_per_class,
        loss_type=args.loss_type, remove_long_samps=args.remove_long_samps,
        stacks_dir=args.stacks_dir, device=args.device)
    return ckpt_dir


def cmd_emt_disc_train(args):
    """Returns the checkpoint directory."""
    from .disc.train import emt_disc_train
    cfg = get_config(args.preset, args.hparams)
    ckpt_dir, _ = emt_disc_train(
        cfg, args.input_path, args.base_dir, train_steps=args.train_steps,
        batch_size=args.batch_size, n_classes=args.n_classes,
        device=args.device)
    return ckpt_dir


def cmd_disc_preprocess(args):
    """Returns {split: its stacks directory}."""
    from .disc.data_preprocess import build_speaker_stacks
    cfg = get_config(args.preset, args.hparams)
    return build_speaker_stacks(
        args.corpus_dir, args.output_dir, cfg.audio, n_mels=args.n_mels,
        tisv_frame=args.tisv_frame, top_db=args.top_db,
        edges_only=args.edges_only, test_fraction=args.test_fraction,
        n_jobs=args.n_jobs)


def cmd_disc_test(args):
    """Returns (accuracy, confusion matrix)."""
    from .disc.train import disc_test
    cfg = get_config(args.preset, args.hparams)
    return disc_test(cfg, args.checkpoint, args.map_path,
                     args.output_dir or os.path.join(args.base_dir,
                                                     "disc_test"),
                     kind=args.kind, n_classes=args.n_classes,
                     device=args.device)


def cmd_preprocess(args):
    """Returns the train.txt path."""
    from .data.preprocess import build_from_path, write_metadata
    cfg = get_config(args.preset, args.hparams)
    meta_path = args.metadata or os.path.join(
        args.in_dir, f"metadata_{args.dataset}.txt")
    rows = build_from_path(cfg, meta_path, args.in_dir, args.out_dir,
                           args.dataset, n_jobs=args.n_jobs,
                           serial=args.serial, write_audio=args.write_audio,
                           write_linear=args.write_linear, limit=args.limit)
    return write_metadata(rows, args.out_dir, cfg)


def cmd_wavenet_preprocess(args):
    """Returns the map.txt path."""
    from .data.preprocess import (wavenet_build_from_path,
                                  write_wavenet_metadata)
    cfg = get_config(args.preset, args.hparams)
    rows = wavenet_build_from_path(cfg, args.in_dir, args.out_dir,
                                   n_jobs=args.n_jobs, serial=args.serial,
                                   limit=args.limit)
    return write_wavenet_metadata(rows, args.out_dir, cfg)


def cmd_create_metadata(args):
    """Returns the manifest's path."""
    from .data.preprocess import create_metadata
    return create_metadata(args.in_dir, args.out_path, layout=args.layout,
                           emt_label=args.emt_label, sex=args.sex)


def cmd_vctk_accent(args):
    """Returns the relabelled train.txt's path."""
    from .data.preprocess import vctk_accent_relabel
    return vctk_accent_relabel(args.train_path, args.speaker_info,
                               args.out_path)


def cmd_fixed_eval_set(args):
    """Returns the manifest's path."""
    from .data.feeder import create_fixed_eval_set
    return create_fixed_eval_set(args.input_path, args.out_path,
                                 n_texts=args.n_texts,
                                 n_refs_per_class=args.n_refs_per_class,
                                 min_frames=args.min_frames)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tacotron2_tpu_torch")
    p.add_argument("--preset", default="default")
    p.add_argument("--hparams", default="",
                   help="dotted config overrides, e.g. tacotron.max_iters=500")
    sub = p.add_subparsers(dest="command", required=True)
    pp = sub.add_parser("preprocess", help="corpus wavs -> mel npy (and "
                        "audio / linear npy) + train.txt")
    pp.add_argument("--dataset", required=True)
    pp.add_argument("--in-dir", required=True)
    pp.add_argument("--out-dir", required=True)
    pp.add_argument("--metadata", default=None,
                    help="default <in-dir>/metadata_<dataset>.txt")
    pp.add_argument("--n-jobs", type=int, default=os.cpu_count())
    pp.add_argument("--serial", action="store_true")
    pp.add_argument("--write-audio", action="store_true")
    pp.add_argument("--write-linear", action="store_true")
    pp.add_argument("--limit", type=int, default=None)
    pp.set_defaults(func=cmd_preprocess)

    wp = sub.add_parser("wavenet-preprocess",
                        help="wav folder -> audio/mel npy + map.txt "
                             "(non-GTA vocoder training)")
    wp.add_argument("--in-dir", required=True)
    wp.add_argument("--out-dir", required=True)
    wp.add_argument("--n-jobs", type=int, default=os.cpu_count())
    wp.add_argument("--serial", action="store_true")
    wp.add_argument("--limit", type=int, default=None)
    wp.set_defaults(func=cmd_wavenet_preprocess)

    cm = sub.add_parser("create-metadata",
                        help="corpus layout -> metadata_<ds>.txt manifest")
    cm.add_argument("--in-dir", required=True)
    cm.add_argument("--out-path", required=True)
    cm.add_argument("--layout", default="ljspeech",
                    choices=["ljspeech", "folders", "emt4", "jessa", "emth",
                             "librispeech", "vctk"])
    cm.add_argument("--emt-label", type=int, default=0)
    cm.add_argument("--sex", default="U")
    cm.set_defaults(func=cmd_create_metadata)

    va = sub.add_parser("vctk-accent-relabel",
                        help="rewrite a VCTK train.txt with accent-index "
                             "labels (reference metadata.py:232-261)")
    va.add_argument("--train-path", required=True)
    va.add_argument("--speaker-info", required=True)
    va.add_argument("--out-path", required=True)
    va.set_defaults(func=cmd_vctk_accent)

    sv = sub.add_parser("serve", help="text -> wav through TextToWavProgram")
    sv.add_argument("--checkpoint", required=True,
                    help="Tacotron flax msgpack ({params, batch_stats})")
    sv.add_argument("--wavenet-checkpoint", default=None,
                    help="WaveNet flax msgpack (EMA params); needed with "
                         "--vocoder wavenet")
    sv.add_argument("--vocoder", default="wavenet",
                    choices=("wavenet", "griffin_lim"))
    sv.add_argument("--output-dir", default=".")
    sv.add_argument("--text-list", default=None)
    sv.add_argument("--sentence", default=None)
    sv.add_argument("--ref-mel-emt", default=None)
    sv.add_argument("--ref-mel-spk", default=None)
    sv.add_argument("--serve-batch", type=int, default=8)
    sv.add_argument("--steps", type=int, default=250)
    sv.add_argument("--t-ref", type=int, default=64)
    sv.add_argument("--buckets", default="64,128,256")
    sv.add_argument("--device", default="cuda")
    sv.add_argument("--seed", type=int, default=0)
    sv.set_defaults(func=cmd_serve)

    sy = sub.add_parser("synthesize", help="Tacotron synthesis by --mode "
                        "(text -> mels, map.txt, Griffin-Lim wavs; GTA "
                        "mels; style modes), mels -> WaveNet wavs "
                        "(WaveNet), or both (Tacotron-2)")
    sy.add_argument("--model", default="Tacotron-2",
                    choices=("Tacotron", "WaveNet", "Tacotron-2"))
    sy.add_argument("--mode", default="eval",
                    choices=("eval", "gta", "synthesis", "synthesis_random",
                             "synthesis_multiple", "style_embs"))
    sy.add_argument("--checkpoint", default=None,
                    help="Tacotron flax msgpack ({params, batch_stats}); "
                         "needed with --model Tacotron / Tacotron-2")
    sy.add_argument("--wavenet-checkpoint", default=None,
                    help="WaveNet flax msgpack (EMA params); needed with "
                         "--model WaveNet / Tacotron-2")
    sy.add_argument("--mels-map", default=None,
                    help="map.txt of the mels to vocode (default "
                         "<output-dir>/gta/map.txt with --mode gta, else "
                         "<output-dir>/eval/map.txt)")
    sy.add_argument("--limit", type=int, default=None,
                    help="only the first N rows of the GTA or synthesis "
                         "metadata, and of the map to vocode")
    sy.add_argument("--input-path", default=None,
                    help="train.txt (gta, synthesis_random, "
                         "synthesis_multiple, style_embs)")
    sy.add_argument("--synth-metadata", default=None,
                    help="synthesis-mode metadata (train.txt schema and "
                         "reference columns 12/14)")
    sy.add_argument("--input-dir", default=None,
                    help="preprocessed data root the reference mels are "
                         "resolved under (default: the input's directory)")
    sy.add_argument("--flip-spk-emt", action="store_true")
    sy.add_argument("--paired", action="store_true")
    sy.add_argument("--n-spk", type=int, default=8)
    sy.add_argument("--n-per-spk", type=int, default=8)
    sy.add_argument("--output-dir", default="tacotron_output")
    sy.add_argument("--text-list", default=None)
    sy.add_argument("--sentence", default=None)
    sy.add_argument("--ref-mel-emt", default=None)
    sy.add_argument("--ref-mel-spk", default=None)
    sy.add_argument("--device", default="cuda")
    sy.add_argument("--seed", type=int, default=0)
    sy.set_defaults(func=cmd_synthesize)

    tr = sub.add_parser("train", help="Tacotron training on a train.txt, "
                        "WaveNet training on a GTA map.txt, or both "
                        "(Tacotron-2)")
    tr.add_argument("--model", default="Tacotron",
                    choices=("Tacotron", "WaveNet", "Tacotron-2"))
    tr.add_argument("--input-path", required=True,
                    help="train.txt (Tacotron, Tacotron-2) or map.txt "
                         "(WaveNet)")
    tr.add_argument("--base-dir", default=".")
    tr.add_argument("--train-steps", type=int, default=None)
    tr.add_argument("--wavenet-train-steps", type=int, default=None,
                    help="WaveNet steps of --model Tacotron-2 (default "
                         "--train-steps)")
    tr.add_argument("--batch-size", type=int, default=None)
    tr.add_argument("--wavenet-batch-size", type=int, default=None,
                    help="WaveNet batch of --model Tacotron-2")
    tr.add_argument("--no-gta", action="store_true",
                    help="--model WaveNet on a train.txt's own mels")
    tr.add_argument("--restore", action="store_true")
    tr.add_argument("--checkpoint-interval", type=int, default=None)
    tr.add_argument("--eval-interval", type=int, default=None)
    tr.add_argument("--slack-url", default=None,
                    help="webhook that receives the run's milestones")
    tr.add_argument("--verbose", action="store_true",
                    help="log the whole config at the start")
    tr.add_argument("--profile-start", type=int, default=None,
                    help="step after which a torch.profiler trace starts")
    tr.add_argument("--profile-end", type=int, default=None,
                    help="step after which it stops (default start + 5)")
    tr.add_argument("--pretrained-disc-emt", default=None,
                    help="emotion discriminator to graft into "
                         "pretrained_ref_enc_emt (a disc-train checkpoint "
                         "directory or a TF checkpoint)")
    tr.add_argument("--pretrained-disc-spk", default=None,
                    help="speaker discriminator for pretrained_ref_enc_spk")
    tr.add_argument("--save-output-vars", action="store_true")
    for flag in TRAIN_FLAGS:
        tr.add_argument(f"--{flag}", action="store_true")
    tr.add_argument("--device", default="cuda")
    tr.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun: the process group's backend "
                         "(default nccl on the card, gloo on the CPU; gloo "
                         "for ranks that share a card)")
    tr.set_defaults(func=cmd_train)

    dt = sub.add_parser("disc-train", help="emotion / speaker / accent "
                        "discriminator (GE2E or CE)")
    dt.add_argument("--input-path", default=None,
                    help="train.txt metadata (omit with --stacks-dir)")
    dt.add_argument("--base-dir", default="runs")
    dt.add_argument("--kind", default="emt",
                    choices=("emt", "spk", "accent"))
    dt.add_argument("--train-steps", type=int, default=10000)
    dt.add_argument("--n-per-class", type=int, default=8)
    dt.add_argument("--loss-type", default="softmax",
                    choices=("softmax", "contrast", "ce"))
    dt.add_argument("--remove-long-samps", action="store_true")
    dt.add_argument("--stacks-dir", default=None,
                    help="train on disc-preprocess's TI-SV speaker stacks "
                         "instead of train.txt metadata")
    dt.add_argument("--device", default="cuda")
    dt.set_defaults(func=cmd_disc_train)

    et = sub.add_parser("emt-disc-train", help="standalone CNN+GRU emotion "
                        "classifier (reference emt_disc/train.py)")
    et.add_argument("--input-path", required=True)
    et.add_argument("--base-dir", default="runs")
    et.add_argument("--train-steps", type=int, default=2000)
    et.add_argument("--batch-size", type=int, default=32)
    et.add_argument("--n-classes", type=int, default=4)
    et.add_argument("--device", default="cuda")
    et.set_defaults(func=cmd_emt_disc_train)

    dp = sub.add_parser("disc-preprocess", help="TI-SV per-speaker log-mel "
                        "stacks from a <corpus>/<speaker>/**/*.wav layout "
                        "(reference spk_disc/data_preprocess.py)")
    dp.add_argument("--corpus-dir", required=True)
    dp.add_argument("--output-dir", required=True)
    dp.add_argument("--n-mels", type=int, default=40)
    dp.add_argument("--tisv-frame", type=int, default=140)
    dp.add_argument("--top-db", type=float, default=20.0)
    dp.add_argument("--edges-only", action="store_true",
                    help="keep only the first and last window of each "
                         "voiced interval (the VCTK variant)")
    dp.add_argument("--test-fraction", type=float, default=0.1)
    dp.add_argument("--n-jobs", type=int, default=None)
    dp.set_defaults(func=cmd_disc_preprocess)

    dx = sub.add_parser("disc-test", help="classify synthesized mels with a "
                        "trained discriminator (reference test_disc)")
    dx.add_argument("--checkpoint", required=True,
                    help="a disc-train checkpoint directory")
    dx.add_argument("--map-path", required=True,
                    help="synthesis map.txt or train.txt")
    dx.add_argument("--base-dir", default="runs")
    dx.add_argument("--kind", default="emt",
                    choices=("emt", "spk", "accent"))
    dx.add_argument("--n-classes", type=int, default=None)
    dx.add_argument("--output-dir", default=None,
                    help="default <base-dir>/disc_test")
    dx.add_argument("--device", default="cuda")
    dx.set_defaults(func=cmd_disc_test)

    fe = sub.add_parser("fixed-eval-set", help="a reproducible style-"
                        "transfer eval manifest (reference "
                        "create_test_samps_fixed)")
    fe.add_argument("--input-path", required=True, help="train.txt")
    fe.add_argument("--out-path", required=True)
    fe.add_argument("--n-texts", type=int, default=5)
    fe.add_argument("--n-refs-per-class", type=int, default=5)
    fe.add_argument("--min-frames", type=int, default=200)
    fe.set_defaults(func=cmd_fixed_eval_set)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
