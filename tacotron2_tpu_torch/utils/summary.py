"""Training summaries: scalar metrics and a profiler window.

Counterpart of tacotron2_tpu/utils/summary.py. `SummaryWriter` appends
one JSON row a call to <log_dir>/metrics.jsonl ({"step", "time", and each
scalar under its prefix: "tacotron/", "wavenet/", "eval/"}) and, where
`torch.utils.tensorboard` imports, mirrors the scalars into TensorBoard
event files under <log_dir>/events. TensorBoard is imported with its own
TensorFlow stub (the `tensorboard.compat.notf` marker), so that a host
with TensorFlow installed does not import it for the event files.

`ProfilerHook` is `torch.profiler` over the steps (start, end]: after step
`start_step` it starts a trace of CPU activity (and CUDA activity where a
card is present), after step `end_step` (default start + 5) it stops and
exports a Chrome trace to <log_dir>/profile/trace-<start>.json;
`close()` stops and exports a trace that is still open.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types
from typing import Dict, Optional


def _tensorboard_writer(log_dir: str):
    """torch's TensorBoard writer on <log_dir>/events, or None where it
    does not import."""
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        return None
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter as TBWriter
        return TBWriter(os.path.join(log_dir, "events"))
    except Exception:
        return None


class SummaryWriter:
    """Scalar metrics -> metrics.jsonl (+ TensorBoard events)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                       encoding="utf-8", buffering=1)
        self._tb = _tensorboard_writer(log_dir)

    def scalars(self, step: int, values: Dict[str, float],
                prefix: str = "") -> None:
        row = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            try:
                row[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class ProfilerHook:
    """A torch.profiler trace over the steps (start_step, end_step]."""

    def __init__(self, log_dir: str, start_step: Optional[int] = None,
                 end_step: Optional[int] = None):
        self.trace_dir = os.path.join(log_dir, "profile")
        self.start_step = start_step
        self.end_step = end_step if end_step is not None else (
            start_step + 5 if start_step is not None else None)
        self.trace_path = None
        self._prof = None

    def step(self, step: int) -> None:
        """Call after each train step with the step count it reached."""
        if self.start_step is None:
            return
        if self._prof is None and self.start_step <= step < self.end_step:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        elif self._prof is not None and step >= self.end_step:
            self.close()

    def close(self) -> None:
        """Stop and export an open trace."""
        if self._prof is None:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.trace_dir, f"trace-{self.start_step}.json")
        prof.export_chrome_trace(self.trace_path)
