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


def table_bytes(ids, wid, h0, h1, rows0, rows1, reach=512):
    """Bytes of the merge-table rows a round on the rows ids [R, C] (words
    wid) must read at the keys (h0, h1): only pairs inside one word can
    merge (the position alive, the next alive within `reach`, both of one
    word), and for each such pair table 0's row, and table 1's where table
    0 does not hold the pair; each distinct row once, a row being one
    32 B sector."""
    R, C = ids.shape
    col = torch.arange(C, device=ids.device)
    at = torch.flip(torch.cummin(torch.flip(torch.where(ids >= 0, col, C), [1]), 1).values, [1])
    nxt = torch.cat([at[:, 1:], torch.full((R, 1), C, dtype=at.dtype, device=at.device)], 1)
    j = nxt.clamp(max=C - 1)
    nid = torch.gather(ids, 1, j)
    pair = (ids >= 0) & (nxt < C) & (nxt - col <= reach) & (torch.gather(wid, 1, j) == wid)
    r0 = rows0[h0[pair].long()]
    in0 = (r0[:, 0] == ids[pair]) & (r0[:, 1] == nid[pair])
    rows = torch.unique(h0[pair]).numel() + torch.unique(h1[pair][~in0]).numel()
    return rows * rows0.shape[1] * rows0.element_size()


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
