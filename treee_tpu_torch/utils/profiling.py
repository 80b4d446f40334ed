"""Tracing and profiling of the port (``treee_tpu/utils/profiling.py``).

``phase_timer`` wall-clocks named phases; given ``block_on`` (a tensor or a
device), it first waits for the CUDA stream that computes it, so the time
covers the device's work and not only its enqueue.  ``device_trace`` wraps
``torch.profiler`` for a trace of the card (TensorBoard or Perfetto).
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

log = logging.getLogger("treee_tpu_torch")

_TIMINGS: dict[str, list[float]] = {}


def _synchronize(block_on) -> None:
    """Wait for PyTorch's current stream on the device of ``block_on`` (a
    tensor or a device); nothing to wait for on the CPU."""
    dev = block_on.device if torch.is_tensor(block_on) else torch.device(
        block_on)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


@contextlib.contextmanager
def phase_timer(name: str, block_on=None):
    """Wall-clock a phase; optionally wait for a tensor's or a device's
    CUDA stream before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            _synchronize(block_on)
        dt = time.perf_counter() - t0
        _TIMINGS.setdefault(name, []).append(dt)
        log.info("phase %-24s %8.3f s", name, dt)


def timings() -> dict[str, list[float]]:
    """All recorded phase durations (seconds) this process."""
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the host and, where there is one, the
    card, written to ``log_dir`` (view in TensorBoard or Perfetto)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
