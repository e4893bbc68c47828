"""Profiling / tracing helpers.

The reference's only instrumentation is wall-clock prints and progress
bars (SURVEY.md §5). Here:

- :func:`trace` — context manager wrapping ``jax.profiler`` trace capture
  (open the output dir in TensorBoard/XProf; step phases show up as the
  ``onmf.*`` named scopes emitted by the training step);
- :class:`Throughput` — patches/sec counter that fences with
  ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "Throughput"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Throughput:
    """Measure items/sec of a jitted computation with proper fencing.

    >>> tp = Throughput()
    >>> with tp.measure(items=iters * batch):
    ...     out = train(state)
    ...     tp.fence(out.W)
    >>> tp.items_per_sec
    """

    def __init__(self):
        self.items_per_sec = None
        self.elapsed = None

    @contextlib.contextmanager
    def measure(self, items: int):
        # reset first: a raising block must not leave a previous run's
        # numbers behind for error-handling callers to misreport
        self.items_per_sec = None
        self.elapsed = None
        t0 = time.perf_counter()
        yield self
        self.elapsed = time.perf_counter() - t0
        self.items_per_sec = items / self.elapsed

    @staticmethod
    def fence(x):
        """Wait until every leaf of the pytree ``x`` is computed (leaves
        can come from separate dispatches); returns ``x``."""
        return jax.block_until_ready(x)
