"""Kernel timing on the card with CUDA events, shared by `chip_smoke.py`
and the tools of this package."""

from __future__ import annotations

import statistics

import torch

SLEEP_CYCLES = 50_000_000  # 25 ms at 1.98 GHz: time for the host to queue a run


def median_ms(fn, launches):
    """Milliseconds per call: CUDA events around `launches` back-to-back
    calls, after two warm-up calls; the median of five such runs.  Each run
    is queued behind a sleep kernel, so the calls reach the card before it
    starts them and the events time the card's work, not the host's
    launches."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)
