#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`tokenizers_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels of `tokenizers_tpu_torch/csrc/` with nvcc
   (one process per source, all at once) and prints what ptxas reports.
2. Holds each kernel of the gpt2 path bit for bit against its plain
   PyTorch version on the card, at that path's shapes: the layout kernel
   (B3) on a [256, 8192] corpus chunk, the keys (B2) and merge-round (B1)
   kernels on the first rounds of that chunk's real [74, 4096] unique
   buffer, then at the compacted widths 2560 and 2048 and on a
   ladder-sized [37, 2048] slice.  Times each kernel and its plain version
   with CUDA events.
3. Drives the gpt2 path: `Tokenizer.encode_batch_fast` on 512 8 KB corpus
   documents (two [256, 8192] ASCII chunks and one [32, 8192] chunk of the
   documents with multi-byte characters), cold and then on the warm word
   cache, with every kernel's launch count set to 0 just before the cold
   run and read just after it.  Every document's ids must match its
   committed SHA-256 (`tokenizers_tpu_torch/data/`).
4. B4, the standalone merge round: at the llama-3 path's unique-buffer
   shape (its first [256, 8192] ASCII chunk, whole-word bypass applied),
   then at the widths 2560 and 2048 and a [37, 2048] slice, B4 must equal
   its plain version and the first four outputs of B2 then B1, and B2 and
   B1 there must equal their plain versions (all outputs).  Then the
   one entry that reaches it, `bpe_merge2._round`, merges that buffer to
   completion (counts set to 0 first), and must end where the B2/B1 loop
   ends.
5. Drives the llama3 path the same way as 3, on the same documents with
   the llama3_128k tokenizer: cold launches of B1 and B2 above 0 and of
   B3 at 0 (the layout kernel is gpt2's), every digest matched.
6. Prints a line of numbers per path, the per-kernel JSON line, the card's
   name and power limit, and last `{"ok": true, "device": {...}}`.

Any mismatch or error exits non-zero; there is no fallback.  Without a
card, or without the rest of the repo beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
GPT2 = os.path.join(FIXTURES, "gpt2", "tokenizer.json")
LLAMA3 = os.path.join(FIXTURES, "llama3_128k", "tokenizer.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SLEEP_CYCLES = 50_000_000  # 25 ms at 1.98 GHz: time for the host to queue a run
TPU_KERNELS = {  # file:line of the `pallas_call` each kernel replaces
    "layout_fused": "tokenizers_tpu/ops/layout_pallas.py:176",
    "keys": "tokenizers_tpu/ops/merge_pallas.py:258",
    "merge_round_fused": "tokenizers_tpu/ops/merge_pallas.py:283",
    "merge_round_standalone": "tokenizers_tpu/ops/merge_pallas.py:315",
}
SOURCES = {
    "layout_fused": "tokenizers_tpu_torch/csrc/layout.cu",
    "keys": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_fused": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_standalone": "tokenizers_tpu_torch/csrc/merge_round.cu",
}
# the compacted states of the merge loop each kernel is checked at:
# (width, rows): full unique buffer, 5/8 and 1/2 width, a ladder rung
STATES = ((4096, None), (2560, None), (2048, None), (2048, 37))


def _median_ms(torch, fn, launches):
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


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def _table_bytes(torch, h0, h1, rows0):
    """Bytes of the merge-table rows a round reads at the keys (h0, h1):
    each distinct row of either table once, a row being one 32 B sector."""
    row = rows0.shape[1] * rows0.element_size()
    return (torch.unique(h0).numel() + torch.unique(h1).numel()) * row


def _check_equal(torch, name, got, want):
    """Bit-for-bit equality of two output tuples; returns max |diff|."""
    err = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise SystemExit(f"{name}: output {k} differs from its reference")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def _first_ascii_chunk(torch, eng, prepared):
    from tokenizers_tpu_torch.ops.packing import pack_batch

    buf, lens, _ = next(c for c in pack_batch(prepared)
                        if c[0].shape == (256, 8192) and eng._is_ascii(c[0]))
    b = torch.from_numpy(buf).cuda().to(torch.int32)
    n = torch.from_numpy(lens).cuda()
    inb = torch.arange(b.shape[1], device=b.device)[None, :] < n[:, None]
    return b, n, inb


def drive_path(torch, tok, docs, config, counts):
    """`encode_batch_fast` on `docs`, cold then on the warm word cache;
    every launch count set to 0 just before each run and read just after.
    Returns the runs' numbers; raises on a document that differs from its
    digest."""
    from tokenizers_tpu_torch.ops import engine_base
    from tokenizers_tpu_torch.smoke_data import ids_digest, load_digests

    eng = tok._get_device_engine()
    if eng is None:
        raise SystemExit(f"{config}: no device engine")
    program_s = []
    run_program = eng._program_many

    def timed_program(chunks_):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_program(chunks_)
        torch.cuda.synchronize()
        program_s.append(time.perf_counter() - t)
        return out

    eng._program_many = timed_program
    digests = load_digests(config)
    runs = {}
    for run in ("cold", "cached"):
        for c in counts.values():
            for k in c:
                c[k] = 0
        engine_base.STATS.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        encs = tok.encode_batch_fast(docs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: c[k] for k, c in counts.items()}
        bad = [i for i, e in enumerate(encs) if ids_digest(e.ids) != digests[i]]
        if bad:
            raise SystemExit(f"{config} {run}: {len(bad)} documents differ from "
                             f"their digests: {bad[:10]}")
        runs[run] = dict(secs=secs, program_s=program_s[-1], launches=launches,
                         **engine_base.STATS.snapshot())
    eng._program_many = run_program
    return runs


def path_numbers(eng, docs, prepared, runs, config):
    from tokenizers_tpu_torch.ops.packing import pack_batch

    nbytes = sum(len(p) for p in prepared)
    return {
        "config": config, "docs": len(docs), "bytes": nbytes,
        "chunks": [list(c[0].shape) + [bool(eng._is_ascii(c[0]))]
                   for c in pack_batch(prepared)],
        **{f"{run}_MBps": nbytes / r["secs"] / 1e6 for run, r in runs.items()},
        **{f"{run}_program_MBps": nbytes / r["program_s"] / 1e6 for run, r in runs.items()},
        **{f"{run}_bad_row_fraction": r["bad_row_fraction"] for run, r in runs.items()},
        **{f"{run}_launches": r["launches"] for run, r in runs.items()},
        "patched_words": runs["cold"]["patched_words"],
        "digests_matched": len(docs),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops import kernel_build
    from tokenizers_tpu_torch.ops import layout_kernels as lk
    from tokenizers_tpu_torch.ops import merge_kernels as mk
    from tokenizers_tpu_torch.ops.bpe_dedup import (
        H1_MULT, H2_MULT, buffer_geometry, dedup_layout, unique_buffer,
        whole_word_ids, word_hash_heads,
    )
    from tokenizers_tpu_torch.ops.bpe_merge2 import _round, compact, init_own, make_round_driver
    from tokenizers_tpu_torch.ops.layout_kernels import next_boundary
    from tokenizers_tpu_torch.ops.llama3_presplit import llama3_boundaries
    from tokenizers_tpu_torch.smoke_data import build_docs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernel_build.build()
    print(f"nvcc build {time.perf_counter() - t0:.3f} s", flush=True)
    for src, log in sorted(kernel_build.LOGS.items()):
        print(f"== ptxas {src}\n{log.strip()}", flush=True)

    # ---- 2. the gpt2 path's kernels against their plain versions ----------
    tok = Tokenizer.from_file(GPT2)
    eng = tok._get_device_engine()
    T = eng.tables
    docs = build_docs()
    prepared = [eng._prepare(d) for d in docs]
    b, n, inb = _first_ascii_chunk(torch, eng, prepared)
    stats = {}

    got = lk.layout_fused(b, n)
    want = lk.layout_fused_plain(b, n)
    stats["layout_fused"] = {
        "max_abs_err": _check_equal(torch, "layout_fused", got, want),
        "ms": _median_ms(torch, lambda: lk.layout_fused(b, n), 20),
        "plain_ms": _median_ms(torch, lambda: lk.layout_fused_plain(b, n), 2),
        "bound_ms": _nbytes(b, n, *got) / HBM_BYTES_PER_S * 1e3,
        "shape": list(b.shape),
    }
    print(f"B3 bit-equal (tolerance 0) at {list(b.shape)}", flush=True)
    bnd, nxt, h1, h2 = got
    geom = buffer_geometry(b.numel())
    fits, ops = dedup_layout(b, bnd, inb, n, nxt, T["seed"], geom, hashes=(h1, h2))
    if not fits:
        raise SystemExit("the corpus chunk does not fit its dedup buffer")
    b_u, _uh, inb_u, wid_u, _we, _up = unique_buffer(ops, b, geom)
    ids = torch.where(inb_u, T["byte2id"][b_u.to(torch.int64)], -1)
    own_l, own_r = init_own(ids, T["merge_mclr"])
    rows0, rows1, seed = T["merge_rows0"], T["merge_rows1"], T["seed"]
    errs = {"keys": 0, "merge_round_fused": 0}
    wid = wid_u
    for width, rows in STATES:
        if ids.shape[1] != width:
            ids, wid, _bad, (own_l, own_r) = compact(ids, wid, width, (own_l, own_r))
        st_ids, st_wid, st_l, st_r = (x[:rows].contiguous() for x in (ids, wid, own_l, own_r))
        k_got = mk.keys(st_ids, rows0, seed)
        errs["keys"] = max(errs["keys"], _check_equal(
            torch, f"keys {list(st_ids.shape)}", k_got, mk.keys_plain(st_ids, rows0, seed)))
        st = (st_ids, st_l, st_r) + tuple(k_got)
        for _ in range(2):
            r_got = mk.merge_round_fused(*st[:3], st_wid, *st[3:], rows0, rows1, seed)
            r_want = mk.merge_round_fused_plain(*st[:3], st_wid, *st[3:], rows0, rows1, seed)
            errs["merge_round_fused"] = max(errs["merge_round_fused"], _check_equal(
                torch, f"merge_round_fused {list(st_ids.shape)}", r_got, r_want))
            st = (r_got[0], r_got[1], r_got[2], r_got[4], r_got[5], r_got[6])
        if rows is None:
            ids, own_l, own_r = st[0], st[1], st[2]
        print(f"B1/B2 bit-equal (tolerance 0) at {list(st_ids.shape)}; merged heads "
              f"in the last round: {int(r_got[3].sum())}", flush=True)

    # timing at the main path's unique-buffer shape [74, 4096]
    ids, wid = torch.where(inb_u, T["byte2id"][b_u.to(torch.int64)], -1), wid_u
    own_l, own_r = init_own(ids, T["merge_mclr"])
    keys0 = mk.keys(ids, rows0, seed)
    stats["keys"] = {
        "max_abs_err": errs["keys"],
        "ms": _median_ms(torch, lambda: mk.keys(ids, rows0, seed), 20),
        "plain_ms": _median_ms(torch, lambda: mk.keys_plain(ids, rows0, seed), 2),
        "bound_ms": _nbytes(ids, *keys0) / HBM_BYTES_PER_S * 1e3,
        "shape": list(ids.shape),
    }
    args = (ids, own_l, own_r, wid, *keys0, rows0, rows1, seed)
    r_out = mk.merge_round_fused(*args)
    stats["merge_round_fused"] = {
        "max_abs_err": errs["merge_round_fused"],
        "ms": _median_ms(torch, lambda: mk.merge_round_fused(*args), 20),
        "plain_ms": _median_ms(torch, lambda: mk.merge_round_fused_plain(*args), 2),
        "bound_ms": (_nbytes(*args[:7], *r_out) + _table_bytes(torch, *keys0[:2], rows0))
                    / HBM_BYTES_PER_S * 1e3,
        "shape": list(ids.shape),
    }
    torch.cuda.synchronize()

    # ---- 3. the gpt2 path, cold then warm ---------------------------------
    counts = {"layout_fused": lk.LAUNCHES, "keys": mk.LAUNCHES,
              "merge_round_fused": mk.LAUNCHES, "merge_round_standalone": mk.LAUNCHES}
    runs = drive_path(torch, tok, docs, "gpt2", counts)
    zero = [k for k in ("layout_fused", "keys", "merge_round_fused")
            if runs["cold"]["launches"][k] == 0]
    if zero:
        raise SystemExit(f"the gpt2 path never launched {zero}")
    for k in ("layout_fused", "keys", "merge_round_fused"):
        stats[k]["launches"] = runs["cold"]["launches"][k]
        stats[k]["launches_from"] = "gpt2 path, cold"
    numbers = {"gpt2": path_numbers(eng, docs, prepared, runs, "gpt2")}
    print("numbers " + json.dumps(numbers["gpt2"]), flush=True)

    # ---- 4. B4 at the llama-3 path's unique buffer ------------------------
    t = time.perf_counter()
    tok3 = Tokenizer.from_file(LLAMA3)
    eng3 = tok3._get_device_engine()
    if eng3 is None:
        raise SystemExit("llama3_128k: no device engine")
    llama3_build_s = time.perf_counter() - t
    print(f"llama3_128k tables {llama3_build_s:.3f} s", flush=True)
    T3 = eng3.tables
    prepared3 = [eng3._prepare(d) for d in docs]
    b, n, inb = _first_ascii_chunk(torch, eng3, prepared3)
    bnd, _ = llama3_boundaries(b, inb, T3["cls_table"], ascii_only=True)
    fits, ops = dedup_layout(b, bnd, inb, n, next_boundary(bnd), T3["seed"], geom)
    if not fits:
        raise SystemExit("the llama3 corpus chunk does not fit its dedup buffer")
    b_u, uhead, inb_u, wid_u, wend_f, upos_f = unique_buffer(ops, b, geom)
    ids = torch.where(inb_u, T3["byte2id"][b_u.to(torch.int64)], -1)
    ids0 = whole_word_ids(
        ids, uhead, inb_u, word_hash_heads(b_u, uhead, inb_u, H1_MULT),
        word_hash_heads(b_u, uhead, inb_u, H2_MULT),
        torch.where(uhead, wend_f - upos_f, 0), T3["ww_rows0"], T3["ww_rows1"],
        T3["ww_seed"],
    )
    rows0, rows1, seed = T3["merge_rows0"], T3["merge_rows1"], T3["seed"]
    own_l0, own_r0 = init_own(ids0, T3["merge_mclr"])
    ids, own_l, own_r, wid = ids0, own_l0, own_r0, wid_u
    err4 = 0
    for width, rows in STATES:
        if ids.shape[1] != width:
            ids, wid, _bad, (own_l, own_r) = compact(ids, wid, width, (own_l, own_r))
        st = tuple(x[:rows].contiguous() for x in (ids, own_l, own_r))
        st_wid = wid[:rows].contiguous()
        for _ in range(2):
            got = mk.merge_round_standalone(*st, st_wid, rows0, rows1, seed)
            err4 = max(err4, _check_equal(
                torch, f"merge_round_standalone {list(st_wid.shape)}", got,
                mk.merge_round_standalone_plain(*st, st_wid, rows0, rows1, seed)))
            # B2 and B1 on the llama3 state, each against its plain version
            k_got = mk.keys(st[0], rows0, seed)
            errs["keys"] = max(errs["keys"], _check_equal(
                torch, f"keys {list(st_wid.shape)} (llama3)", k_got,
                mk.keys_plain(st[0], rows0, seed)))
            chain = mk.merge_round_fused(*st, st_wid, *k_got, rows0, rows1, seed)
            errs["merge_round_fused"] = max(errs["merge_round_fused"], _check_equal(
                torch, f"merge_round_fused {list(st_wid.shape)} (llama3)", chain,
                mk.merge_round_fused_plain(*st, st_wid, *k_got, rows0, rows1, seed)))
            _check_equal(torch, f"merge_round_standalone {list(st_wid.shape)} against B2, B1",
                         got, chain[:4])
            st = got[:3]
        if rows is None:
            ids, own_l, own_r = st
        print(f"B4 bit-equal (tolerance 0) to its plain version and to B2, B1, and "
              f"B2, B1 to theirs, at "
              f"{list(st_wid.shape)}; merged heads in the last round: {int(got[3].sum())}",
              flush=True)
    for k in ("keys", "merge_round_fused"):
        stats[k]["max_abs_err"] = errs[k]
    args4 = (ids0, own_l0, own_r0, wid_u, rows0, rows1, seed)
    out4 = mk.merge_round_standalone(*args4)
    keys4 = mk.keys_plain(ids0, rows0, seed)
    stats["merge_round_standalone"] = {
        "max_abs_err": err4,
        "ms": _median_ms(torch, lambda: mk.merge_round_standalone(*args4), 20),
        "plain_ms": _median_ms(torch, lambda: mk.merge_round_standalone_plain(*args4), 2),
        "bound_ms": (_nbytes(*args4[:4], *out4) + _table_bytes(torch, *keys4[:2], rows0))
                    / HBM_BYTES_PER_S * 1e3,
        "shape": list(ids0.shape),
    }
    # B4's own path: `_round` merges the buffer to completion
    for c in counts.values():
        for k in c:
            c[k] = 0
    st, rounds = (ids0, own_l0, own_r0), 0
    while True:
        a, l_, r_, f = _round(*st, wid_u, rows0, rows1, seed)
        st, rounds = (a, l_, r_), rounds + 1
        if not bool(f.any()):
            break
    stats["merge_round_standalone"]["launches"] = mk.LAUNCHES["merge_round_standalone"]
    stats["merge_round_standalone"]["launches_from"] = (
        "its own phase: bpe_merge2._round to completion on the llama3 unique buffer")
    if stats["merge_round_standalone"]["launches"] != rounds:
        raise SystemExit("_round did not launch B4 once per round")
    init, step, unpack = make_round_driver(wid_u, rows0, rows1, seed)
    cst = init(ids0, own_l0, own_r0)
    while True:
        cst, f = step(cst)
        if not bool(f.any()):
            break
    _check_equal(torch, "_round to completion against the B2/B1 loop", st, unpack(cst))
    print(f"_round: {rounds} B4 rounds to completion at {list(ids0.shape)}, equal to "
          f"the B2/B1 loop", flush=True)

    # ---- 5. the llama3 path, cold then warm -------------------------------
    runs3 = drive_path(torch, tok3, docs, "llama3", counts)
    cold3 = runs3["cold"]["launches"]
    if cold3["keys"] == 0 or cold3["merge_round_fused"] == 0 or cold3["layout_fused"] != 0:
        raise SystemExit(f"llama3 cold launches {cold3}: want B1, B2 > 0 and B3 = 0")
    numbers["llama3"] = path_numbers(eng3, docs, prepared3, runs3, "llama3")
    numbers["llama3"]["tables_s"] = llama3_build_s
    numbers["llama3"]["b4_rounds_to_completion"] = rounds
    print("numbers " + json.dumps(numbers["llama3"]), flush=True)
    print("kernel_numbers " + json.dumps({
        "kernel_median_ms": {k: s["ms"] for k, s in stats.items()},
        "kernel_bound_us": {k: s["bound_ms"] * 1e3 for k, s in stats.items()},
        "kernel_shapes": {k: s["shape"] for k, s in stats.items()},
    }), flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": TPU_KERNELS[k],
         "launches": s["launches"], "launches_from": s["launches_from"],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": None}
        for k, s in stats.items()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
