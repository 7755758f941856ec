"""Shared utilities of the port: a timed logger, the security arithmetic
and the AirScript literal inliners.

Counterpart of ``genstark_tpu/utils/__init__.py`` (`Logger`, `pow_log2`,
`inline_vector`, `inline_matrix`).
"""

from __future__ import annotations

import math
import time
from typing import Optional


class Logger:
    """Timed step logging: `start` returns a log function that prints each
    message with the milliseconds since the previous one."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def start(self, message: Optional[str] = None):
        last = [time.monotonic()]
        if message:
            print(self.prefix + message)

        def log(msg: str):
            now = time.monotonic()
            print(f"{self.prefix}{msg} ({(now - last[0]) * 1000:.0f} ms)")
            last[0] = now
        return log


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
