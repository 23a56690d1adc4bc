"""Run logging: stdout, an append-only log file and an optional webhook.

Counterpart of tacotron2_tpu/utils/infolog.py (reference code/infolog.py:
13-47): `init` opens <log_dir>/train.log with the same header block,
`log` prints a line and appends it to the file with a millisecond
timestamp, and a message logged with `slack=True` is posted to the
webhook given to `init` (`--slack-url`), from a daemon thread with the
standard library's `urllib`, best-effort. `ValueWindow` is the rolling
mean of the host loops' log lines (reference tacotron/utils/__init__.py).
"""

from __future__ import annotations

import atexit
import json
import threading
from collections import deque
from datetime import datetime
from typing import Optional

import numpy as np

_format = "%Y-%m-%d %H:%M:%S.%f"
_file = None
_run_name = None
_webhook_url = None
PREFIX = "[tacotron2_tpu_torch] "


def init(filename: str, run_name: str, webhook_url: Optional[str] = None):
    """Append this run's header to `filename` and log into it from now on;
    `webhook_url` receives the messages logged with slack=True."""
    global _file, _run_name, _webhook_url
    _close_logfile()
    _file = open(filename, "a", encoding="utf-8")
    _file.write("\n-----------------------------------------------------------"
                "------\n")
    _file.write(f"Starting new {run_name} training run\n")
    _file.write("-----------------------------------------------------------"
                "------\n")
    _run_name = run_name
    _webhook_url = webhook_url


def log(msg: str, end: str = "\n", slack: bool = False) -> None:
    print(PREFIX + msg, end=end, flush=True)
    if _file is not None:
        _file.write(f"[{datetime.now().strftime(_format)[:-3]}] {msg}{end}")
        _file.flush()
    if slack and _webhook_url is not None:
        _send_webhook(msg)


def _send_webhook(msg: str) -> None:
    from urllib.request import Request, urlopen

    def worker():
        try:
            body = json.dumps({"text": f"{_run_name}: {msg}"}).encode()
            urlopen(Request(_webhook_url, data=body,
                            headers={"Content-Type": "application/json"}),
                    timeout=10)
        except Exception:
            pass  # best-effort: logging never stops training

    threading.Thread(target=worker, daemon=True).start()


def _close_logfile() -> None:
    global _file
    if _file is not None:
        _file.close()
        _file = None


atexit.register(_close_logfile)


class ValueWindow:
    """The mean of the last `size` values."""

    def __init__(self, size: int = 100):
        self.values = deque(maxlen=size)

    def append(self, x: float) -> None:
        self.values.append(float(x))

    @property
    def average(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0
