"""Shared utilities of the port: a timed logger, the security arithmetic
and the AirScript literal inliners.

Counterpart of ``genstark_tpu/utils/__init__.py`` (`Logger` :11-56,
`NoopLogger`/`noop_logger` :63-77, `is_power_of_2`, `pow_log2`,
`inline_vector`, `inline_matrix`).
"""

from __future__ import annotations

import math
import time
from typing import Optional


class Logger:
    """Timed step logging with nested sub-logs: `start` returns a log
    function that prints each message with the milliseconds since the
    previous one, `sub` opens an indented one (a no-op when sub-logs are
    off), `done` closes one with its total time."""

    def __init__(self, enable_sub_logs: bool = True, prefix: str = ""):
        self.enable_sub_logs = enable_sub_logs
        self.prefix = prefix
        self._starts = {}
        self._lasts = {}

    def start(self, message: Optional[str] = None, prefix: str = ""):
        now = time.monotonic()
        label = object()
        self._starts[label] = now
        self._lasts[label] = now
        if message:
            print(self.prefix + message)

        def log(message: str):
            self._log(label, prefix, message)
        log._label = label
        return log

    def sub(self, message: Optional[str] = None):
        if self.enable_sub_logs:
            return self.start(message, prefix="  ")
        return _noop_log

    def done(self, log, message: Optional[str] = None):
        label = getattr(log, "_label", None)
        if label is None:
            return
        if message:
            elapsed = (time.monotonic() - self._starts[label]) * 1000
            print(f"{self.prefix}{message} in {elapsed:.0f} ms")
        self._starts.pop(label, None)
        self._lasts.pop(label, None)

    def _log(self, label, prefix: str, message: str):
        now = time.monotonic()
        elapsed = (now - self._lasts[label]) * 1000
        self._lasts[label] = now
        print(f"{self.prefix}{prefix}{message} ({elapsed:.0f} ms)")


def _noop_log(message: str):
    pass


class NoopLogger(Logger):
    """A Logger that prints nothing."""

    def __init__(self):
        super().__init__(False)

    def start(self, message=None, prefix=""):
        return _noop_log

    def sub(self, message=None):
        return _noop_log

    def done(self, log, message=None):
        pass


noop_logger = NoopLogger()


def is_power_of_2(value: int) -> bool:
    return value != 0 and (value & (value - 1)) == 0


def pow_log2(base: float, exponent: int) -> float:
    """log2(base^exponent) with the powers of two of the exponent factored
    out, so the float power cannot overflow."""
    twos = 0
    while exponent % 2 == 0:
        twos += 1
        exponent //= 2
    return (2 ** twos) * math.log2(base ** exponent)


def inline_vector(values) -> str:
    """Render ints as an AirScript vector literal (the reference's
    `inline.vector`)."""
    return "[" + ", ".join(str(int(v)) for v in values) + "]"


def inline_matrix(rows) -> str:
    """Render ints as an AirScript matrix literal (the reference's
    `inline.matrix`)."""
    return "[" + ", ".join(inline_vector(r) for r in rows) + "]"
