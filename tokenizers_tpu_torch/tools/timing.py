"""Kernel timing on the card with CUDA events, and the bytes bound a time
is held against, shared by `chip_smoke.py` and the tools of this
package."""

from __future__ import annotations

import statistics

import torch

SLEEP_CYCLES = 50_000_000  # 25 ms at 1.98 GHz: time for the host to queue a run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def table_bytes(h0, h1, rows0):
    """Bytes of the merge-table rows a round reads at the keys (h0, h1):
    each distinct row of either table once, a row being one 32 B sector."""
    row = rows0.shape[1] * rows0.element_size()
    return (torch.unique(h0).numel() + torch.unique(h1).numel()) * row


def bound_ms(n_bytes):
    """The least time to move n_bytes at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


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
