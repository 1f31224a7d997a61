"""Tracing / profiling (SURVEY §5.1).

The reference's observability is ad-hoc wall-clock prints around self-play
and training (ref ``Training/AlphaZero.py:504,582-585,655,680-682``,
``Testing/TestManager.py:86,168-173``).  This build makes both
first-class:

- :func:`trace_capture` wraps a block in a ``jax.profiler`` trace
  (TensorBoard / Perfetto / xprof readable) — the tool the reference never
  had.  Enable for a training run with ``NUZERO_TRACE_DIR=/path`` (the
  coordinator captures a few early steps) or for ``bench.py`` with
  ``BENCH_TRACE_DIR=/path``.
- :class:`PhaseTimers` accumulates per-phase wall-clock (self-play, train,
  eval, checkpoint) and emits ``time/<phase>`` metrics for the journal.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


@contextlib.contextmanager
def trace_capture(log_dir: str):
    """Capture a ``jax.profiler`` trace of the enclosed block into
    ``log_dir`` (view with TensorBoard's profile plugin or Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimers:
    """Per-phase wall-clock accumulators.

    >>> timers = PhaseTimers()
    >>> with timers.phase("selfplay"): ...
    >>> timers.metrics()  # {"time/selfplay": ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._last: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._last[name] = dt

    def metrics(self, last: bool = True) -> Dict[str, float]:
        """``time/<phase>`` values — the most recent interval by default,
        or cumulative totals with ``last=False``."""
        src = self._last if last else self.totals
        return {f"time/{k}": round(v, 6) for k, v in src.items()}
