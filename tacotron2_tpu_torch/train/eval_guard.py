"""Consecutive-failure guard for the periodic eval paths.

Counterpart of tacotron2_tpu/train/eval_guard.py: the train loop's evals
swallow exceptions so that a transient failure cannot kill a long run, as
the reference's do, but a systematically broken eval would then go
unnoticed; the guard counts consecutive failures of one eval path and
raises once `limit` in a row have failed.
"""

from __future__ import annotations


class EvalFailureGuard:
    """Tracks consecutive failures of one eval path; raises after `limit`."""

    def __init__(self, name: str, limit: int = 3):
        self.name = name
        self.limit = max(1, limit)
        self.consecutive = 0

    def success(self) -> None:
        self.consecutive = 0

    def failure(self, step: int, exc: BaseException, log=print) -> None:
        """Record one failure; raise once the consecutive limit is hit."""
        self.consecutive += 1
        log(f"{self.name} failed at step {step} "
            f"({self.consecutive}/{self.limit} consecutive): {exc}")
        if self.consecutive >= self.limit:
            raise RuntimeError(
                f"{self.name} failed {self.consecutive} times in a row "
                f"(last at step {step}): the eval path is broken") from exc
