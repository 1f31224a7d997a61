"""Metrics journal + progress reporting.

Replaces the reference's pickled plot-data series and stdout prints
(ref ``Training/AlphaZero.py:963-1251``, ``Utils/Progress_Bars/PrintBar.py``)
with an append-only JSONL journal (one record per training step) that the
offline plotter (``nuzero/utils/plots.py``) renders.  JSONL survives
crashes, appends atomically, and resumes trivially (truncate to step).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional


class MetricsJournal:
    def __init__(self, path: Optional[str], write: bool = True):
        """``write=False`` makes appends/truncates no-ops while keeping
        ``load`` functional — multi-controller runs journal from process 0
        only (every process reads the shared journal for resume)."""
        self.path = path
        self.write = write
        if path and write:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def append(self, record: Dict[str, Any]) -> None:
        record = dict(record, ts=time.time())
        if self.path and self.write:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def load(self) -> List[Dict[str, Any]]:
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def truncate_to_step(self, step: int) -> None:
        """Resume support: drop records past ``step``
        (ref ``AlphaZero.py:1204-1251`` plot truncation)."""
        records = [r for r in self.load() if r.get("step", 0) <= step]
        if self.path and self.write:
            with open(self.path, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")


class PrintBar:
    """Flush-friendly block progress bar (ref ``PrintBar.py:2-22``)."""

    def __init__(self, name: str, total: int, width: int = 15):
        self.name = name
        self.total = max(total, 1)
        self.width = width
        self.n = 0
        self._render()

    def _render(self):
        filled = int(self.width * self.n / self.total)
        bar = "#" * filled + "-" * (self.width - filled)
        sys.stdout.write(f"\r{self.name} [{bar}] {self.n}/{self.total}")
        sys.stdout.flush()

    def next(self):
        self.n += 1
        self._render()

    def finish(self):
        self.n = self.total
        self._render()
        sys.stdout.write("\n")
        sys.stdout.flush()
