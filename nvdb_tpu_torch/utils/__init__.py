"""Small shared helpers: ceil-div, padding, timing."""

from __future__ import annotations

import time


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return cdiv(x, m) * m


class WallTimer:
    """Monotonic wall-clock span timer (the steady_clock analogue,
    nvdb_bench.cpp:24-27)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3
        return False
