"""Per-phase times of B1's row kernel on the card.

    python -m tokenizers_tpu_torch.tools.b1_phases

Loads `csrc/merge_round.cu` as shipped and built with -DTT_ROW_PHASES,
where thread 0 of each block stamps the SM clock at the start, after each
of the six barriers and at the end.  Runs both through
`merge_kernels.merge_round_fused` at the gpt2 path's states
(`chip_smoke.py`'s): the unique buffer of the first [256, 8192] ASCII
corpus chunk at [74, 4096], and at [74, 2048] after two rounds at 4096 and
at 2560.  Every output must equal `merge_round_fused_plain`.  Prints, per
state, one JSON line: the ms of the kernel and of its timing build (CUDA
events, `timing.median_ms`), and the mean and largest SM cycles of each
phase over the blocks, beside the SM clock and the card's name and power
limit from nvidia-smi.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from .. import Tokenizer
from ..ops import layout_kernels as lk
from ..ops import merge_kernels as mk
from ..ops.bpe_merge2 import compact
from ..ops.kernel_build import check_status
from ..smoke_data import GPT2_JSON, build_docs, first_ascii_chunk, unique_state
from .timing import median_ms

PHASES = (  # between consecutive stamps
    "load, table rows, scan (a)",
    "pair validity, rank, next MCR",
    "run flags, safety, scan (b)",
    "scan (b) walk: counts, mins, run starts",
    "parity, word min: the merge set",
    "apply, stores, scan (c)",
    "next keys, stores",
)
N_STAMPS = len(PHASES) + 1
ROW_TIMED = 256  # blocks that stamp (csrc: ROW_TIMED)


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def gpt2_states():
    """{width: B1's args} at [74, 4096] and [74, 2048] of the gpt2 path."""
    eng = Tokenizer.from_file(GPT2_JSON)._get_device_engine()
    T = eng.tables
    b, n, inb = first_ascii_chunk(eng, [eng._prepare(d) for d in build_docs()])
    ids, own_l, own_r, wid = unique_state(eng, b, n, inb, lk.layout_fused(b, n))
    tabs = (T["merge_rows0"], T["merge_rows1"], T["seed"])
    states = {}
    for width in (4096, 2560, 2048):
        if ids.shape[1] != width:
            ids, wid, _bad, (own_l, own_r) = compact(ids, wid, width, (own_l, own_r))
        st = (ids, own_l, own_r, wid, *mk.keys(ids, tabs[0], tabs[2]), *tabs)
        if width != 2560:
            states[width] = st
        for _ in range(2):
            out = mk.merge_round_fused_plain(*st)
            st = (out[0], out[1], out[2], wid, out[4], out[5], out[6], *tabs)
        ids, own_l, own_r = st[:3]
    return states


def main() -> None:
    smi = _smi("name,power.limit")
    lib = mk.load()
    tlib = mk.load(("TT_ROW_PHASES",))
    tlib.tt_row_stamps_read.argtypes = [ctypes.c_void_p]
    tlib.tt_row_stamps_read.restype = ctypes.c_int
    for width, args in gpt2_states().items():
        want = mk.merge_round_fused_plain(*args)
        for which in (lib, tlib):
            for g, w in zip(mk.merge_round_fused(*args, lib=which), want):
                if not torch.equal(g, w):
                    raise SystemExit(f"[74, {width}]: differs from the plain B1")
        ms = median_ms(lambda: mk.merge_round_fused(*args, lib=lib), 20)
        timed_ms = median_ms(lambda: mk.merge_round_fused(*args, lib=tlib), 20)
        mk.merge_round_fused(*args, lib=tlib)
        torch.cuda.synchronize()
        stamps = torch.zeros(ROW_TIMED * N_STAMPS, dtype=torch.int64)
        check_status("tt_row_stamps_read", tlib.tt_row_stamps_read(stamps.data_ptr()))
        R = args[0].shape[0]
        d = stamps.view(ROW_TIMED, N_STAMPS)[:R].diff(dim=1).double()
        print(json.dumps({
            "shape": list(args[0].shape), "ms": ms, "timed_build_ms": timed_ms,
            "phase_cycles_mean": dict(zip(PHASES, d.mean(0).tolist())),
            "phase_cycles_max": dict(zip(PHASES, d.max(0).values.tolist())),
            "total_cycles_mean": float(d.sum(1).mean()),
            "sm_clock_mhz_now_max": _smi("clocks.sm,clocks.max.sm"), "card": smi,
        }), flush=True)


if __name__ == "__main__":
    main()
