"""Hierarchical phase timers (analogue of CodeTiming,
src/Headers/CodeTiming.h:132-194 / src/Common/CodeTiming.cpp:238-).

Host-side wall timers around jitted phases.  Note device work is async;
callers timing a jitted phase precisely should block_until_ready first.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class CodeTiming:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def block(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = time.perf_counter() - self._t0
        lines = [f"{'Block':<28}{'Wall (s)':>12}{'Calls':>8}{'%':>8}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total > 0 else 0.0
            lines.append(f"{name:<28}{t:>12.4f}{self.counts[name]:>8}"
                         f"{pct:>8.1f}")
        lines.append(f"{'TOTAL':<28}{total:>12.4f}")
        return "\n".join(lines)

    def write(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write(self.report() + "\n")
