"""Blind A/B human-evaluation set builder.

The port's copy of tacotron2_tpu/eval/human_eval.py:20-62, host code in
plain Python and numpy.

Reference: single_use/analyze_results.py:human_test_randomize (:9-39) — takes
two folders of wavs with matching filenames ('new' model vs 'bsl' baseline),
shuffles the utterance order, randomizes which system plays first in each
pair, copies them to anonymized `test_<i>_<j>.wav` names, and writes the
answer key CSV for scoring after the listening test.
"""

from __future__ import annotations

import csv
import os
from shutil import copyfile
from typing import Optional

import numpy as np


def build_ab_test(new_dir: str, baseline_dir: str, out_dir: str,
                  answers_csv: Optional[str] = None, seed: int = 0) -> str:
    """Randomize matching wavs from two systems into a blind A/B test set."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(new_dir) if f.endswith(".wav"))
    files = [f for f in files if os.path.exists(os.path.join(baseline_dir, f))]
    if not files:
        raise ValueError("no matching .wav filenames between the two folders")
    order = rng.permutation(len(files))

    answers_csv = answers_csv or os.path.join(out_dir, "human_test_answers.csv")
    with open(answers_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["files", "test1", "test2"])
        for i, fi in enumerate(order):
            name = files[int(fi)]
            new_first = bool(rng.integers(0, 2))
            srcs = [os.path.join(new_dir if new_first else baseline_dir, name),
                    os.path.join(baseline_dir if new_first else new_dir, name)]
            for j, src in enumerate(srcs):
                copyfile(src, os.path.join(out_dir, f"test_{i}_{j}.wav"))
            w.writerow([name, "new" if new_first else "bsl",
                        "bsl" if new_first else "new"])
    return answers_csv


def score_ab_test(answers_csv: str, responses_csv: str) -> dict:
    """Join listener responses (`index,choice` with choice in {1,2}) against
    the answer key; returns preference counts for the 'new' system."""
    key = {}
    with open(answers_csv, encoding="utf-8") as f:
        for i, row in enumerate(csv.DictReader(f)):
            key[i] = (row["test1"], row["test2"])
    prefer_new = total = 0
    with open(responses_csv, encoding="utf-8") as f:
        for row in csv.DictReader(f):
            i, choice = int(row["index"]), int(row["choice"])
            total += 1
            if key[i][choice - 1] == "new":
                prefer_new += 1
    return dict(prefer_new=prefer_new, total=total,
                preference_rate=prefer_new / max(total, 1))
