"""Style discriminator training, import and test (PyTorch).

Counterpart of tacotron2_tpu/disc/train.py (reference code/spk_disc/
main.py:15-37, model.py, emt_disc/train.py:11-82):

- `DiscFeeder` groups train.txt rows by class (emotion column 8, speaker
  9, or the accent kind: column 8, the `keep_top_accents` largest classes)
  and yields N classes × M crops of `crop_frames` frames (shorter mels
  padded with -max_abs_value); `DiscStackFeeder` draws N speakers × M
  windows from `disc-preprocess`'s TI-SV stacks. Both make the JAX
  feeders' `np.random.default_rng(seed)` calls in the same order, so the
  same seed gives the same batches bit for bit.
- `disc_train` trains a `DiscriminatorModel` (CE head, or GE2E softmax /
  contrast) with clip_by_global_norm(3.0) and Adam, `emt_disc_train` the
  standalone `EmtDisc` with plain Adam(1e-4), its per-class val split and
  val loss and accuracy every `eval_interval` steps; both log JAX's lines,
  checkpoint at JAX's cadence (a flax tree {"params", "batch_stats"} per
  `train/checkpoint.py`) and write a curve, one JSON object a step, beside
  the checkpoints (disc_<kind>_curve.jsonl, emt_disc_curve.jsonl).
- `load_pretrained_disc` reads such a checkpoint's encoder subtree and
  statistics for the Tacotron graft; `disc_test` classifies the mels of a
  synthesis map.txt or a train.txt and writes the CSV and the confusion
  plot.

The JAX trainers initialise from PRNGKey(0), which the port cannot draw;
a fresh port discriminator is drawn from a seeded `torch.Generator`
(`convert.init_params`), and `init=` starts one from given flax trees
(the parity tests hand it the JAX init). The JAX package's orbax disc
checkpoints are not read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import Config
from ..convert import disc_to_flax, init_params, load_disc
from ..train.checkpoint import CheckpointManager
from ..train.optim import Adam
from ..utils import ValueWindow, log
from .model import DiscriminatorModel, EmtDisc, disc_ce_loss, ge2e_loss, \
    similarity_matrix


class DiscFeeder:
    """train.txt rows by class -> [N·M, crop, num_mels] batches."""

    def __init__(self, cfg: Config, metadata_path: str, kind: str = "emt",
                 crop_frames: int = 128, seed: int = 1234,
                 remove_long_samps: bool = False, keep_top_accents: int = 5):
        self.cfg = cfg
        self.kind = kind
        self.crop = crop_frames
        self.data_dir = os.path.dirname(metadata_path)
        self.rng = np.random.default_rng(seed)
        with open(metadata_path, encoding="utf-8") as f:
            rows = [line.strip().split("|") for line in f if line.strip()]
        if remove_long_samps:
            n_before = len(rows)
            rows = [r for r in rows if int(r[6]) < 500]
            log(f"disc feeder: removed long samples {n_before} -> {len(rows)}")
        col = 9 if kind == "spk" else 8
        self.by_class: Dict[int, list] = {}
        for r in rows:
            self.by_class.setdefault(int(float(r[col])), []).append(r)
        if kind == "accent" and len(self.by_class) > keep_top_accents:
            top = sorted(self.by_class,
                         key=lambda c: len(self.by_class[c]),
                         reverse=True)[:keep_top_accents]
            self.by_class = {c: self.by_class[c] for c in sorted(top)}
            log(f"disc feeder: kept {keep_top_accents} largest accents "
                f"{sorted(top)}")
        self.classes = sorted(self.by_class)

    @property
    def n_classes(self) -> int:
        return max(self.classes) + 1

    def _load_crop(self, row) -> np.ndarray:
        mel = np.load(os.path.join(self.data_dir, row[0], "mels", row[2]))
        if len(mel) >= self.crop:
            start = int(self.rng.integers(0, len(mel) - self.crop + 1))
            return mel[start:start + self.crop]
        return np.pad(mel, ((0, self.crop - len(mel)), (0, 0)),
                      constant_values=-self.cfg.audio.max_abs_value)

    def batches(self, N: Optional[int] = None, M: int = 8) -> Iterator[Dict]:
        N = N or len(self.classes)
        while True:
            chosen = self.rng.choice(self.classes, size=N,
                                     replace=N > len(self.classes))
            mels, labels = [], []
            for c in chosen:
                rows = self.by_class[int(c)]
                for i in self.rng.integers(0, len(rows), size=M):
                    mels.append(self._load_crop(rows[int(i)]))
                    labels.append(int(c))
            yield dict(mels=np.stack(mels).astype(np.float32),
                       labels=np.asarray(labels, np.int32), N=N, M=M)


class DiscStackFeeder:
    """GE2E batches from per-speaker TI-SV stacks `speaker<i>.npy`
    ([n_windows, n_mels, frames]): N speakers × M windows, each yielded
    time-major [frames, n_mels], labels the stack index (utils.py
    random_batch_old, :30-107)."""

    def __init__(self, stacks_dir: str, seed: int = 1234):
        paths = [p for p in os.listdir(stacks_dir)
                 if re.fullmatch(r"speaker\d+\.npy", p)]
        if not paths:
            raise FileNotFoundError(
                f"no speaker<i>.npy stacks in {stacks_dir!r}; run "
                "`disc-preprocess` first")
        paths.sort(key=lambda p: int(p[len("speaker"):-len(".npy")]))
        self.stacks = [np.load(os.path.join(stacks_dir, p), mmap_mode="r")
                       for p in paths]
        self.rng = np.random.default_rng(seed)
        self.classes = list(range(len(self.stacks)))

    @property
    def n_classes(self) -> int:
        return len(self.stacks)

    def batches(self, N: Optional[int] = None, M: int = 8) -> Iterator[Dict]:
        N = N or min(4, self.n_classes)
        while True:
            chosen = self.rng.choice(self.n_classes, size=N,
                                     replace=N > self.n_classes)
            mels, labels = [], []
            for c in chosen:
                stack = self.stacks[int(c)]
                for i in self.rng.integers(0, stack.shape[0], size=M):
                    mels.append(np.asarray(stack[int(i)]).T)
                    labels.append(int(c))
            yield dict(mels=np.stack(mels).astype(np.float32),
                       labels=np.asarray(labels, np.int32), N=N, M=M)


class DiscTrainer:
    """A discriminator, its optimizer and the step of JAX `disc_train`'s
    `loss_fn` / `step` (or `emt_disc_train`'s with `use_ce`)."""

    def __init__(self, model: torch.nn.Module, n_classes: int, *,
                 use_ce: bool, loss_type: str = "ce",
                 learning_rate: float = 1e-3, clip: Optional[float] = 3.0):
        self.model, self.n_classes = model, n_classes
        self.use_ce, self.loss_type = use_ce, loss_type
        self.device = next(model.parameters()).device
        self.params = list(model.parameters())
        self.opt = Adam(self.params, learning_rate, max_norm=clip)

    def loss(self, mels, labels, N: int, M: int, train: bool = True):
        """(loss, accuracy, embeddings) of a batch; in train mode the
        BatchNorm running statistics move."""
        mels = torch.as_tensor(np.asarray(mels), device=self.device)
        labels = torch.as_tensor(np.asarray(labels),
                                 device=self.device).long()
        emb, logits = self.model(mels, train=train)
        if self.use_ce:
            loss, acc = disc_ce_loss(logits, labels, self.n_classes)
        else:
            S = similarity_matrix(emb, self.model.w, self.model.b, N, M)
            loss = ge2e_loss(S, N, M, self.loss_type)
            want = torch.arange(N, device=self.device).repeat_interleave(M)
            acc = (S.argmax(-1) == want).float().mean()
        return loss, acc, emb

    def step(self, mels, labels, N: int, M: int):
        """One optimizer step; returns (loss, accuracy, embeddings)."""
        loss, acc, emb = self.loss(mels, labels, N, M)
        grads = torch.autograd.grad(loss, self.params)
        self.opt.step(self.params, grads)
        return loss.detach(), acc, emb.detach()

    @torch.no_grad()
    def evaluate(self, mels, labels, N: int = 0, M: int = 0):
        """(loss, accuracy) in eval mode: the running statistics."""
        loss, acc, _ = self.loss(mels, labels, N, M, train=False)
        return loss, acc

    def tree(self) -> dict:
        """{"params", "batch_stats"}: the checkpoint's flax trees."""
        params, stats = disc_to_flax(self.model)
        return {"params": params, "batch_stats": stats}


def _start(model, cfg: Config, init: Optional[dict], device):
    """The model from `init`'s flax trees, else from a seeded draw."""
    if init is not None:
        load_disc(model, init["params"], init.get("batch_stats", {}))
    else:
        init_params(model, cfg, torch.Generator().manual_seed(0))
    return model.to(device)


def disc_train(cfg: Config, input_path: Optional[str], base_dir: str, *,
               kind: str = "emt", train_steps: int = 10000,
               n_per_class: int = 8, loss_type: str = "softmax",
               learning_rate: float = 1e-3,
               checkpoint_interval: int = 1000,
               remove_long_samps: bool = False,
               stacks_dir: Optional[str] = None, device="cuda",
               init: Optional[dict] = None):
    """Train an emt / spk / accent discriminator (loss_type "ce" for the
    CE head, else GE2E); checkpoints under <base_dir>/disc_<kind>/.
    `stacks_dir` trains on TI-SV speaker stacks instead of train.txt
    rows. Returns (checkpoint directory, the final flax params tree)."""
    if stacks_dir is not None:
        feeder = DiscStackFeeder(stacks_dir)
    else:
        if not input_path:
            raise ValueError("disc_train needs --input-path (train.txt) "
                             "or --stacks-dir")
        feeder = DiscFeeder(cfg, input_path, kind=kind,
                            remove_long_samps=remove_long_samps)
    use_ce = loss_type == "ce"
    it = feeder.batches(M=n_per_class)
    batch = next(it)            # the JAX trainer initialises on it
    model = DiscriminatorModel(cfg, feeder.n_classes, discriminator=use_ce,
                               num_mels=batch["mels"].shape[-1])
    trainer = DiscTrainer(_start(model, cfg, init, device), feeder.n_classes,
                          use_ce=use_ce, loss_type=loss_type,
                          learning_rate=learning_rate, clip=3.0)
    N, M = batch["N"], batch["M"]

    ckpt_dir = os.path.join(base_dir, f"disc_{kind}")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=5)
    loss_w, acc_w = ValueWindow(100), ValueWindow(100)
    with open(os.path.join(base_dir, f"disc_{kind}_curve.jsonl"), "a",
              encoding="utf-8") as curve:
        for i in range(1, train_steps + 1):
            b = next(it)
            loss, acc, _ = trainer.step(b["mels"], b["labels"], N, M)
            loss_w.append(float(loss))
            acc_w.append(float(acc))
            curve.write(json.dumps(dict(step=i, loss=float(loss),
                                        acc=float(acc))) + "\n")
            if i % 50 == 0 or i < 3:
                log(f"disc[{kind}] step {i}: loss={loss_w.average:.4f} "
                    f"acc={acc_w.average:.3f}")
            if i % checkpoint_interval == 0 or i == train_steps:
                mgr.save(i, trainer.tree())
    log(f"Discriminator training done -> {ckpt_dir}")
    return ckpt_dir, trainer.tree()["params"]


def emt_disc_split(feeder: DiscFeeder, seed: int, test_size: float) -> list:
    """The seed's held-out rows per class (JAX :228-235): ≥ 1 training row
    kept a class, a 1-row class trains only. Moves them out of
    `feeder.by_class` and returns them."""
    rng = np.random.default_rng(seed)
    val_rows = []
    for c, rows in feeder.by_class.items():
        n_val = (max(1, min(int(len(rows) * test_size), len(rows) - 1))
                 if len(rows) > 1 else 0)
        idx = rng.permutation(len(rows))
        val_rows += [rows[i] for i in idx[:n_val]]
        feeder.by_class[c] = [rows[i] for i in idx[n_val:]]
    return val_rows


def emt_disc_train(cfg: Config, input_path: str, base_dir: str, *,
                   train_steps: int = 2000, batch_size: int = 32,
                   learning_rate: float = 1e-4, eval_interval: int = 10,
                   checkpoint_interval: int = 20, n_classes: int = 4,
                   test_size: float = 0.05, seed: int = 1234, device="cuda",
                   init: Optional[dict] = None):
    """The standalone CNN+GRU emotion classifier (emt_disc/train.py):
    Adam 1e-4 on CE over the emotion labels, the val loss and accuracy
    every `eval_interval` steps, a checkpoint every `checkpoint_interval`
    under <base_dir>/emt_disc/. Returns (checkpoint directory, the final
    flax params tree)."""
    feeder = DiscFeeder(cfg, input_path, kind="emt", seed=seed)
    val_rows = emt_disc_split(feeder, seed, test_size)
    model = EmtDisc(cfg, n_classes=n_classes)
    it = feeder.batches(N=min(n_classes, len(feeder.classes)),
                        M=max(1, batch_size // max(1, len(feeder.classes))))
    next(it)                    # the JAX trainer initialises on it
    trainer = DiscTrainer(_start(model, cfg, init, device), n_classes,
                          use_ce=True, learning_rate=learning_rate,
                          clip=None)

    def _eval():
        mels = np.stack([feeder._load_crop(r) for r in val_rows])
        labels = np.asarray([int(float(r[8])) for r in val_rows], np.int32)
        return trainer.evaluate(mels, labels)

    ckpt_dir = os.path.join(base_dir, "emt_disc")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=20)
    loss_w, acc_w = ValueWindow(eval_interval), ValueWindow(eval_interval)
    with open(os.path.join(base_dir, "emt_disc_curve.jsonl"), "a",
              encoding="utf-8") as curve:
        for i in range(1, train_steps + 1):
            b = next(it)
            loss, acc, _ = trainer.step(b["mels"], b["labels"], b["N"],
                                        b["M"])
            loss_w.append(float(loss))
            acc_w.append(float(acc))
            rec = dict(step=i, loss=float(loss), acc=float(acc))
            if i % eval_interval == 0:
                vl, va = _eval()
                rec.update(val_loss=float(vl), val_acc=float(va))
                log(f"emt_disc batches {i} | tr loss {loss_w.average:5.3f} "
                    f"| val loss {float(vl):5.3f} | tr acc "
                    f"{acc_w.average*100:4.1f}% | val acc "
                    f"{float(va)*100:4.1f}%")
            curve.write(json.dumps(rec) + "\n")
            if i % checkpoint_interval == 0 or i == train_steps:
                mgr.save(i, trainer.tree())
    log(f"emt_disc training done -> {ckpt_dir}")
    return ckpt_dir, trainer.tree()["params"]


def load_pretrained_disc(ckpt_dir: str) -> dict:
    """The newest disc checkpoint under `ckpt_dir` for the Tacotron
    graft: {"params": the encoder subtree, "batch_stats": its statistics
    or {}}, from a whole DiscriminatorModel tree (`disc_train`'s) or a bare
    encoder tree."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no discriminator checkpoint directory "
                                f"{ckpt_dir!r}")
    restored = CheckpointManager(ckpt_dir).load()
    params = restored.get("params", restored)
    bs = restored.get("batch_stats") or {}
    if isinstance(params, dict) and "pretrained_ref_enc" in params:
        params = params["pretrained_ref_enc"]
        bs = bs.get("pretrained_ref_enc", {}) if isinstance(bs, dict) else {}
    return {"params": params, "batch_stats": bs}


def disc_test(cfg: Config, ckpt_dir: str, map_path: str, out_dir: str, *,
              kind: str = "emt", n_classes: Optional[int] = None,
              crop_frames: int = 128, batch_size: int = 100, device="cuda"):
    """Classify synthesized (or real) mels with a trained CE
    discriminator; writes <out_dir>/disc_test_<kind>.csv (mel,true,pred)
    and confusion_<kind>.png, and returns (accuracy, confusion matrix)
    (reference spk_disc/model.py test_disc). `map_path` rows are
    synthesis maps `mel_path|text|emt|spk` or train.txt rows, whose mels
    lie under <its dir>/<dataset>/mels/."""
    from ..eval.analyze import confusion_matrix, plot_confusion_matrix

    with open(map_path, encoding="utf-8") as f:
        rows = [line.strip().split("|") for line in f if line.strip()]
    data_dir = os.path.dirname(map_path)
    # "accent" reuses the emt column (the emt label doubles as accent id)
    label_col = (3 if kind == "spk" else 2) if rows and rows[0][0].endswith(
        ".npy") else (9 if kind == "spk" else 8)

    def mel_path(r):
        if r[0].endswith(".npy"):
            if os.path.isabs(r[0]) or os.path.exists(r[0]):
                return r[0]
            return os.path.join(data_dir, r[0])
        return os.path.join(data_dir, r[0], "mels", r[2])

    labels = [int(float(r[label_col])) for r in rows]
    n_cls = n_classes or max(labels) + 1
    model = DiscriminatorModel(cfg, n_cls, discriminator=True)
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no discriminator checkpoint directory "
                                f"{ckpt_dir!r}")
    restored = CheckpointManager(ckpt_dir).load()
    load_disc(model, restored["params"], restored.get("batch_stats", {}))
    model = model.to(device).eval().requires_grad_(False)

    pad_val = -cfg.audio.max_abs_value
    preds = []
    with torch.no_grad():
        for start in range(0, len(rows), batch_size):
            mels = []
            for r in rows[start:start + batch_size]:
                mel = np.load(mel_path(r))[:crop_frames]
                if len(mel) < crop_frames:
                    mel = np.pad(mel, ((0, crop_frames - len(mel)), (0, 0)),
                                 constant_values=pad_val)
                mels.append(mel)
            x = torch.as_tensor(np.stack(mels).astype(np.float32),
                                device=device)
            _, logits = model(x, train=False)
            preds.extend(logits.argmax(-1).cpu().tolist())
    correct = sum(int(p == l) for p, l in zip(preds, labels))
    acc = correct / max(len(labels), 1)

    os.makedirs(out_dir, exist_ok=True)
    cm = confusion_matrix(labels, preds, n_cls)
    plot_confusion_matrix(cm, os.path.join(out_dir, f"confusion_{kind}.png"))
    with open(os.path.join(out_dir, f"disc_test_{kind}.csv"), "w",
              encoding="utf-8") as f:
        f.write("mel,true,pred\n")
        for r, l, p in zip(rows, labels, preds):
            f.write(f"{mel_path(r)},{l},{p}\n")
    log(f"disc-test[{kind}]: acc={acc:.3f} over {len(labels)} samples "
        f"-> {out_dir}")
    return acc, cm
