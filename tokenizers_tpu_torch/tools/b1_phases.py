"""Per-phase times of B1's row kernel, or of its cluster kernel, or of
B4's (the same body without carried keys), on the card.

    python -m tokenizers_tpu_torch.tools.b1_phases [--wide] [--one-cta] [--standalone]

Loads `csrc/merge_round.cu` as shipped and built with -DTT_ROW_PHASES,
where thread 0 of each block stamps the SM clock at the start, after each
of the six barriers and at the end, and the global timer at the start and
the end.  Runs both through `merge_kernels._launch` at the gpt2 path's
states (`chip_smoke.py`'s): the unique buffer of the first [256, 8192]
ASCII corpus chunk at [74, 4096], and at [74, 2048] after two rounds at
4096 and at 2560.  With --wide, through the cluster kernel at
`smoke_data.full_width_states`, [8, 8192] (that chunk's first 8 rows) and
[32, 16384] (dense documents).  With --one-cta, the gpt2 states through
the row kernel and through the cluster kernel's launch with one CTA a
cluster (S = C): the same work, so the difference is what the cluster
machinery (cluster barriers, reads through the cluster window) costs a
CTA.  With --standalone, B4 in place of B1 at the same states (its
phases: `STANDALONE_PHASES`), and without --wide also at the llama-3
path's unique buffer [74, 4096] (`smoke_data.llama3_unique_state`), where
`chip_smoke.py` times it.  Every output must equal the plain version.
Prints, per state, one JSON line: the ms of the kernel and of its timing
build (CUDA events, `timing.median_ms`), the mean and largest SM cycles of
each phase over the blocks, the spread of the blocks' start and end times
on the global timer (ns), beside the SM clock and the card's name and
power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from .. import Tokenizer
from ..ops import layout_kernels as lk
from ..ops import merge_kernels as mk
from ..ops.bpe_merge2 import FILL_K, compact
from ..ops.kernel_build import check_status
from ..smoke_data import (
    CONFIGS, GPT2_JSON, build_docs, first_ascii_chunk, full_width_states, llama3_unique_state,
    unique_state,
)
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
STANDALONE_PHASES = (  # B4: no round (c); stamp 6 is thread 0's, after its stores
    "load, scan (a)",
    "next ids, keys, table rows, pair validity, rank, next MCR",
    "run flags, safety, scan (b)",
    "scan (b) walk: counts, mins, run starts",
    "parity, word min: the merge set",
    "apply, stores (thread 0)",
    "the block's other stores",
)
N_STAMPS = len(PHASES) + 1
ROW_TIMED = 256  # blocks that stamp (csrc: ROW_TIMED)


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def gpt2_states(eng):
    """{(R, C): B1's args (ids, own_l, own_r, wid, h0, h1, nid, rows0,
    rows1, seed)} at [74, 4096] and [74, 2048] of the gpt2 path."""
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
            states[tuple(ids.shape)] = st
        for _ in range(2):
            out = mk.merge_round_fused_plain(*st)
            st = (out[0], out[1], out[2], wid, out[4], out[5], out[6], *tabs)
        ids, own_l, own_r = st[:3]
    return states


def block_spread(stamps, n_blocks, n_stamps):
    """Per-block phase cycles, and the spread of the blocks' start, end
    and length on the global timer (ns: p50, p90, max from the first
    start), from a phase build's stamps."""
    st = stamps.view(-1, n_stamps + 2)[:n_blocks]
    d = st[:, :n_stamps].diff(dim=1).double()
    t0, t1 = st[:, n_stamps], st[:, n_stamps + 1]
    start, end = (t0 - t0.min()).double(), (t1 - t0.min()).double()
    q = torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64)
    return d, {"start_p50_p90_max": start.quantile(q).tolist(),
               "end_p50_p90_max": end.quantile(q).tolist(),
               "length_p50_p90_max": (end - start).quantile(q).tolist()}


def _phases(tlib, run, n_blocks):
    """Run the timing build once and read its stamps: (per-block phase
    cycles, block spread)."""
    run(tlib)
    torch.cuda.synchronize()
    stamps = torch.zeros(ROW_TIMED * (N_STAMPS + 2), dtype=torch.int64)
    check_status("tt_row_stamps_read", tlib.tt_row_stamps_read(stamps.data_ptr()))
    return block_spread(stamps, min(n_blocks, ROW_TIMED), N_STAMPS)


def llama3_state():
    """B1's args at the llama-3 path's unique buffer [74, 4096]."""
    eng3 = Tokenizer.from_file(CONFIGS["llama3"])._get_device_engine()
    T = eng3.tables
    ids, own_l, own_r, wid = llama3_unique_state(eng3)
    return (ids, own_l, own_r, wid, *mk.keys(ids, T["merge_rows0"], T["seed"]),
            T["merge_rows0"], T["merge_rows1"], T["seed"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wide", action="store_true", help="the cluster kernel's states")
    ap.add_argument("--one-cta", action="store_true",
                    help="the gpt2 states through both kernels, the cluster one with one "
                         "CTA a cluster (what the cluster machinery costs a CTA)")
    ap.add_argument("--standalone", action="store_true",
                    help="B4 in place of B1 (and the llama-3 unique buffer)")
    opts = ap.parse_args()
    smi = _smi("name,power.limit")
    lib = mk.load()
    tlib = mk.load(("TT_ROW_PHASES",))
    tlib.tt_row_stamps_read.argtypes = [ctypes.c_void_p]
    tlib.tt_row_stamps_read.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    eng = Tokenizer.from_file(GPT2_JSON)._get_device_engine()
    states = [("gpt2", args) for args in
              (full_width_states(eng) if opts.wide else gpt2_states(eng)).values()]
    if opts.standalone and not opts.wide:
        states.append(("llama3", llama3_state()))
    keys = (lambda args: None) if opts.standalone else (lambda args: args[4:7])
    phases = STANDALONE_PHASES if opts.standalone else PHASES
    for config, args in states:
        R, C = args[0].shape

        def fn(geom):
            return lambda which: mk._launch(geom, args[:4], keys(args), *args[7:], FILL_K,
                                            which)

        if C <= mk.ROW_MAX_C:
            kernels = [("row", (C, 1), fn(None))]
        else:
            geom = mk.cluster_geometry(R, C, sms)
            kernels = [("cluster", geom, fn(geom))]
        if opts.one_cta:
            kernels.append(("cluster of one CTA", (C, 1), fn((C, 1))))
        want = (mk.merge_round_standalone_plain(*args[:4], *args[7:]) if opts.standalone
                else mk.merge_round_fused_plain(*args))
        for name, geom, run in kernels:
            for which in (lib, tlib):
                for g, w in zip(run(which), want):
                    if not torch.equal(g, w):
                        raise SystemExit(f"{name} {[R, C]}: differs from the plain version")
            ms = median_ms(lambda: run(lib), 20)
            timed_ms = median_ms(lambda: run(tlib), 20)
            d, spread = _phases(tlib, run, R * geom[1])
            print(json.dumps({
                "round": "B4" if opts.standalone else "B1", "state": config,
                "kernel": name, "shape": [R, C], "slice_and_cluster": geom, "ms": ms,
                "timed_build_ms": timed_ms,
                "phase_cycles_mean": dict(zip(phases, d.mean(0).tolist())),
                "phase_cycles_max": dict(zip(phases, d.max(0).values.tolist())),
                "total_cycles_mean": float(d.sum(1).mean()), "block_ns": spread,
                "sm_clock_mhz_now_max": _smi("clocks.sm,clocks.max.sm"), "card": smi,
            }), flush=True)


if __name__ == "__main__":
    main()
