"""Word-error-rate computation for synthesized speech vs ground-truth scripts.

The port's copy of tacotron2_tpu/eval/wer.py:16-89, host code in plain
Python. Parity with reference code/single_use/wer.py:91-116 (WER of ASR
transcripts against scripts). The reference shells out to an ASR system
and uses a jiwer-style metric; here the Levenshtein word-distance is
implemented natively and the ASR transcript source is pluggable (a file
of `utterance_id|transcript` rows).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple


def normalize_for_wer(text: str) -> List[str]:
    """Lowercase, strip punctuation, split — standard WER normalization."""
    text = re.sub(r"[^a-z0-9' ]", " ", text.lower())
    return [w for w in text.split() if w]


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[int, int, int, int]:
    """Word-level Levenshtein → (substitutions, deletions, insertions, hits)."""
    m, n = len(ref), len(hyp)
    # dp[i][j] = (cost, S, D, I)
    dp = [[(0, 0, 0, 0)] * (n + 1) for _ in range(m + 1)]
    for i in range(1, m + 1):
        dp[i][0] = (i, 0, i, 0)
    for j in range(1, n + 1):
        dp[0][j] = (j, 0, 0, j)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                dp[i][j] = dp[i - 1][j - 1]
            else:
                sub = (dp[i - 1][j - 1][0] + 1, dp[i - 1][j - 1][1] + 1,
                       dp[i - 1][j - 1][2], dp[i - 1][j - 1][3])
                dele = (dp[i - 1][j][0] + 1, dp[i - 1][j][1],
                        dp[i - 1][j][2] + 1, dp[i - 1][j][3])
                ins = (dp[i][j - 1][0] + 1, dp[i][j - 1][1],
                       dp[i][j - 1][2], dp[i][j - 1][3] + 1)
                dp[i][j] = min(sub, dele, ins)
    cost, S, D, I = dp[m][n]
    return S, D, I, m - S - D


def wer(reference: str, hypothesis: str) -> float:
    """WER = (S + D + I) / N_ref."""
    ref = normalize_for_wer(reference)
    hyp = normalize_for_wer(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    S, D, I, _ = edit_distance(ref, hyp)
    return (S + D + I) / len(ref)


def corpus_wer(pairs: Sequence[Tuple[str, str]]) -> Dict[str, float]:
    """Aggregate WER over (reference, hypothesis) pairs (wer.py:91-116)."""
    total_err = total_words = 0
    per_utt = []
    for ref_text, hyp_text in pairs:
        ref = normalize_for_wer(ref_text)
        hyp = normalize_for_wer(hyp_text)
        if not ref:
            continue
        S, D, I, _ = edit_distance(ref, hyp)
        total_err += S + D + I
        total_words += len(ref)
        per_utt.append((S + D + I) / len(ref))
    return dict(
        wer=total_err / max(total_words, 1),
        mean_utterance_wer=sum(per_utt) / max(len(per_utt), 1),
        n_utterances=len(per_utt), n_words=total_words)


def wer_from_files(scripts_path: str, transcripts_path: str) -> Dict[str, float]:
    """Both files: `utterance_id|text` rows; joined on utterance_id."""
    def load(path):
        out = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                if "|" in line:
                    k, _, v = line.strip().partition("|")
                    out[k] = v
        return out

    scripts, hyps = load(scripts_path), load(transcripts_path)
    pairs = [(scripts[k], hyps[k]) for k in scripts if k in hyps]
    return corpus_wer(pairs)
