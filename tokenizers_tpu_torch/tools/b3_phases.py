"""Per-phase times of B3's row kernel, or of its cluster kernel, on the
card.

    python -m tokenizers_tpu_torch.tools.b3_phases [--wide]

Loads `csrc/layout.cu` as shipped and built with -DTT_LAYOUT_PHASES, where
thread 0 of each block stamps the SM clock at the start, after the load's
barrier, before and after the scan's, and at the end (after one more
barrier).  Runs both through `layout_kernels.layout_fused` on the gpt2
path's first [256, 8192] ASCII corpus chunk (`chip_smoke.py`'s), or with
--wide on the first [64, 32768] chunk of 32 KB corpus documents
(`smoke_data.corpus_chunk`) (the cluster
kernel, 4 CTAs a row); every output must equal `layout_fused_plain`.  Prints one JSON line: the ms of
the kernel and of its timing build (CUDA events, `timing.median_ms`), and
the mean and largest SM cycles of each phase over the blocks, the spread
of the blocks' start and end times on the global timer (ns), the phases of
the slowest blocks, beside the SM clock and the card's name and power
limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from .. import Tokenizer
from ..ops import layout_kernels as lk
from ..ops.kernel_build import check_status
from ..smoke_data import GPT2_JSON, corpus_chunk
from .b1_phases import _smi, block_spread
from .timing import median_ms

PHASES = (  # between consecutive stamps
    "load: int4 reads, bytes to shared memory",
    "own positions: classes, boundaries, word ends, local hashes",
    "the fused scan round",
    "outputs: hash delivery, next boundary, stores",
)
N_STAMPS = len(PHASES) + 1
LROW_TIMED = 256  # blocks that stamp (csrc: LROW_TIMED)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wide", action="store_true", help="the cluster kernel at [64, 32768]")
    shape = (64, 32768) if ap.parse_args().wide else (256, 8192)
    smi = _smi("name,power.limit")
    eng = Tokenizer.from_file(GPT2_JSON)._get_device_engine()
    b, n, _inb = corpus_chunk(eng, shape)
    lib = lk.load()
    tlib = lk.load(("TT_LAYOUT_PHASES",))
    tlib.tt_layout_stamps_read.argtypes = [ctypes.c_void_p]
    tlib.tt_layout_stamps_read.restype = ctypes.c_int
    want = lk.layout_fused_plain(b, n)
    for which in (lib, tlib):
        for g, w in zip(lk.layout_fused(b, n, lib=which), want):
            if not torch.equal(g, w):
                raise SystemExit(f"{list(b.shape)}: differs from the plain B3")
    ms = median_ms(lambda: lk.layout_fused(b, n, lib=lib), 20)
    timed_ms = median_ms(lambda: lk.layout_fused(b, n, lib=tlib), 20)
    lk.layout_fused(b, n, lib=tlib)
    torch.cuda.synchronize()
    stamps = torch.zeros(LROW_TIMED * (N_STAMPS + 2), dtype=torch.int64)
    check_status("tt_layout_stamps_read", tlib.tt_layout_stamps_read(stamps.data_ptr()))
    B, L = b.shape
    S, nc = lk.wide_geometry(L) if L > lk.ROW_MAX_L else (L, 1)
    d, spread = block_spread(stamps, min(B * nc, LROW_TIMED), N_STAMPS)
    slow = d.sum(1).argsort(descending=True)[:4]
    print(json.dumps({
        "shape": [B, L], "slice_and_cluster": [S, nc], "ms": ms, "timed_build_ms": timed_ms,
        "phase_cycles_mean": dict(zip(PHASES, d.mean(0).tolist())),
        "phase_cycles_max": dict(zip(PHASES, d.max(0).values.tolist())),
        "total_cycles_mean": float(d.sum(1).mean()), "block_ns": spread,
        "slowest_blocks": {int(i): {"row_length": int(n[int(i) // nc]),
                                    "phase_cycles": d[i].tolist()} for i in slow},
        "sm_clock_mhz_now_max": _smi("clocks.sm,clocks.max.sm"), "card": smi,
    }), flush=True)


if __name__ == "__main__":
    main()
