"""Profiling, anomaly detection, shape tracing, a step-rate meter and device
memory (counterpart of ``zest_tpu.utils.observability``, with its five
names).

- ``enable_shape_tracing``: the ``"zest_tpu_torch"`` logger's debug stream,
  silent unless a level is set;
- ``enable_anomaly_detection``: autograd's anomaly mode;
- ``profile_trace(log_dir)``: ``torch.profiler`` around a block, its Chrome
  trace written into ``log_dir``;
- ``StepTimer``: steps (or rays) per second over a rolling window;
- ``device_memory_stats``: ``torch.cuda.memory_stats`` per device.
"""
from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

logger = logging.getLogger("zest_tpu_torch")


def enable_shape_tracing(level=logging.INFO):
    """Turn on the shape-trace log stream of the ``"zest_tpu_torch"``
    logger (silent by default; lowering the level flips it on)."""
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s:%(module)s.%(funcName)s %(levelname)s %(message)s")
    logger.setLevel(level)


def enable_anomaly_detection():
    """Autograd's anomaly mode, ``torch.autograd.set_detect_anomaly(True)``:
    a backward that produces a NaN raises, and the error names the forward
    operation whose gradient it was (the forward's stack is recorded).
    ``zest_tpu``'s ``jax_debug_nans`` raises at the operation that first
    produces a NaN, forward or backward; here a NaN made in the forward
    raises only once its gradient is taken. Every operation then records its
    stack, so a step runs slower."""
    torch.autograd.set_detect_anomaly(True)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler.profile`` around the block, with the CUDA activity
    when a card is present, the block's work synchronised at its end; the
    Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing) is written into ``log_dir``. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Rolling steps/sec + rays/sec meter for the training loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0 = time.perf_counter()
        self._count = 0

    def tick(self, n: int = 1):
        self._count += n
        if self._count >= self.window:
            dt = time.perf_counter() - self._t0
            rate = self._count / dt
            self._t0 = time.perf_counter()
            self._count = 0
            return rate
        return None


def device_memory_stats():
    """``torch.cuda.memory_stats(i)`` of each CUDA device, keyed by the
    device's name (``"cuda:0"``, ...); ``{"cpu": None}`` without a card."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
