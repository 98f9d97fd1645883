#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`tokenizers_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels of `tokenizers_tpu_torch/csrc/` with nvcc
   (one process per source, all at once) and prints what ptxas reports.
2. Holds each kernel of the gpt2 path bit for bit against its plain
   PyTorch version on the card, at that path's shapes: the layout kernel
   (B3) on a [256, 8192] corpus chunk, and on the adversarial rows of
   `smoke_data.adversarial_layout_case` at widths 256-8192 (its row
   kernel) and 16384 (its tiled kernel, which the main path never takes:
   its launches there are 0, and those of that phase are reported apart);
   the keys (B2) and merge-round (B1)
   kernels on the first rounds of that chunk's real [74, 4096] unique
   buffer, then at the compacted widths 2560 and 2048 and on a
   ladder-sized [37, 2048] slice, B2 also on every adversarial layout
   of B1's below.  B1 has two kernels, chosen by width:
   the row kernel (C <= 4096) runs there, and both are held on the
   adversarial layouts of `smoke_data.adversarial_case` (the row kernel
   at widths 64-4096, the wide one at 5120 and 8192); the wide one also on
   the full-width branch's state, the chunk's first 8 rows at [8, 8192]
   and at its 5/8 width (the smoke documents never take it: its launches
   on the gpt2 path are 0, and those of that phase are reported apart).
   Times each kernel and its plain version with CUDA events, the two B3
   kernels in turns at [256, 8192] and the two B1 kernels at [74, 4096]
   and [74, 2048], and B2 on one 1024-position tile beside an empty
   kernel (its launch and ramp).
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
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
GPT2 = os.path.join(FIXTURES, "gpt2", "tokenizer.json")
LLAMA3 = os.path.join(FIXTURES, "llama3_128k", "tokenizer.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TPU_KERNELS = {  # file:line of the `pallas_call` each kernel replaces
    "layout_fused": "tokenizers_tpu/ops/layout_pallas.py:176",
    "layout_fused_wide": "tokenizers_tpu/ops/layout_pallas.py:176",
    "keys": "tokenizers_tpu/ops/merge_pallas.py:258",
    "merge_round_fused": "tokenizers_tpu/ops/merge_pallas.py:283",
    "merge_round_fused_wide": "tokenizers_tpu/ops/merge_pallas.py:283",
    "merge_round_standalone": "tokenizers_tpu/ops/merge_pallas.py:315",
}
SOURCES = {
    "layout_fused": "tokenizers_tpu_torch/csrc/layout.cu",
    "layout_fused_wide": "tokenizers_tpu_torch/csrc/layout.cu",
    "keys": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_fused": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_fused_wide": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_standalone": "tokenizers_tpu_torch/csrc/merge_round.cu",
}
# the compacted states of the merge loop each kernel is checked at:
# (width, rows): full unique buffer, 5/8 and 1/2 width, a ladder rung
STATES = ((4096, None), (2560, None), (2048, None), (2048, 37))
# widths of the adversarial layouts: the row kernel's, then the wide one's
ADVERSARIAL_WIDTHS = (64, 256, 1536, 2048, 2560, 4096, 5120, 8192)
LAYOUT_WIDTHS = (256, 1024, 4096, 8192, 16384)  # B3's: row kernel to 8192, then tiled


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


def b1_checked(torch, mk, name, args):
    """One B1 round on args = (ids, own_l, own_r, wid, h0, h1, nid, rows0,
    rows1, seed), held against the plain version; the kernel must be the
    one `merge_round_fused` picks by width.  Returns (outputs, max |diff|)."""
    wide = args[0].shape[1] > mk.ROW_MAX_C
    before = mk.LAUNCHES["merge_round_fused_wide"]
    got = mk.merge_round_fused(*args)
    if mk.LAUNCHES["merge_round_fused_wide"] - before != int(wide):
        raise SystemExit(f"{name}: B1 took the wrong kernel at width {args[0].shape[1]}")
    return got, _check_equal(torch, name, got, mk.merge_round_fused_plain(*args))


def b1_rounds(torch, mk, name, st, wid, rows0, rows1, seed, rounds):
    """`rounds` checked B1 rounds from the state st = (ids, own_l, own_r,
    h0, h1, nid).  Returns (state, max |diff|)."""
    err = 0
    for _ in range(rounds):
        got, e = b1_checked(torch, mk, name, (*st[:3], wid, *st[3:], rows0, rows1, seed))
        err = max(err, e)
        st = (got[0], got[1], got[2], got[4], got[5], got[6])
    return st, err


def adversarial_b3(torch, lk):
    """Both B3 kernels against the plain version on the adversarial rows,
    the kernel each width takes read from the launch counts.  Returns
    ({kernel: max |diff|}, launches of the tiled kernel)."""
    from tokenizers_tpu_torch.smoke_data import adversarial_layout_case

    errs = {"layout_fused": 0, "layout_fused_wide": 0}
    wide0 = lk.LAUNCHES["layout_fused_wide"]
    for L in LAYOUT_WIDTHS:
        buf, lens = adversarial_layout_case(L, 30, L)
        b, n = torch.from_numpy(buf).cuda(), torch.from_numpy(lens).cuda()
        wide = L > lk.ROW_MAX_L
        before = lk.LAUNCHES["layout_fused_wide"]
        got = lk.layout_fused(b, n)
        if lk.LAUNCHES["layout_fused_wide"] - before != int(wide):
            raise SystemExit(f"layout_fused took the wrong kernel at width {L}")
        k = "layout_fused_wide" if wide else "layout_fused"
        errs[k] = max(errs[k], _check_equal(torch, f"{k} adversarial [30, {L}]", got,
                                            lk.layout_fused_plain(b, n)))
    print(f"B3 bit-equal (tolerance 0) on the adversarial rows at [30, L], L in "
          f"{list(LAYOUT_WIDTHS)} (row kernel to {lk.ROW_MAX_L}, tiled beyond)", flush=True)
    return errs, lk.LAUNCHES["layout_fused_wide"] - wide0


def adversarial_b1(torch, mk):
    """B2, then both B1 kernels (three rounds each), on the adversarial
    layouts, each against its plain version."""
    from tokenizers_tpu_torch.ops.bpe_merge2 import init_own
    from tokenizers_tpu_torch.ops.merge_table import CuckooMergeTable, consume_mins
    from tokenizers_tpu_torch.smoke_data import adversarial_case

    errs = {"keys": 0, "merge_round_fused": 0, "merge_round_fused_wide": 0}
    for C in ADVERSARIAL_WIDTHS:
        merges, n_ids, ids, wid = adversarial_case(C, 12, C)
        table = CuckooMergeTable(merges)
        mclr = torch.from_numpy(consume_mins(merges, n_ids)).cuda()
        rows0, rows1 = (torch.from_numpy(table.rows8(t, mclr.cpu().numpy())).cuda()
                        for t in (0, 1))
        ids, wid = torch.from_numpy(ids).cuda(), torch.from_numpy(wid).cuda()
        own_l, own_r = init_own(ids, mclr)
        k_got = mk.keys(ids, rows0, table.seed)
        errs["keys"] = max(errs["keys"], _check_equal(
            torch, f"keys adversarial [12, {C}]", k_got, mk.keys_plain(ids, rows0, table.seed)))
        st = (ids, own_l, own_r) + tuple(k_got)
        k = "merge_round_fused_wide" if C > mk.ROW_MAX_C else "merge_round_fused"
        _st, err = b1_rounds(torch, mk, f"{k} adversarial [12, {C}]", st, wid, rows0,
                             rows1, table.seed, 3)
        errs[k] = max(errs[k], err)
    print(f"B2 and B1 bit-equal (tolerance 0) on the adversarial layouts at [12, C], C in "
          f"{list(ADVERSARIAL_WIDTHS)} (B1's row kernel to {mk.ROW_MAX_C}, wide beyond)",
          flush=True)
    return errs


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
    from tokenizers_tpu_torch.smoke_data import build_docs, first_ascii_chunk, unique_state
    from tokenizers_tpu_torch.tools.timing import median_ms

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
    b, n, inb = first_ascii_chunk(eng, prepared)
    stats = {}

    got = lk.layout_fused(b, n)
    want = lk.layout_fused_plain(b, n)
    b3_errs, b3_wide_launches = adversarial_b3(torch, lk)
    b3_errs["layout_fused"] = max(b3_errs["layout_fused"],
                                  _check_equal(torch, "layout_fused", got, want))
    b3_errs["layout_fused_wide"] = max(b3_errs["layout_fused_wide"], _check_equal(
        torch, "layout_fused_wide", lk.layout_fused_wide(b, n), want))
    # the row kernel and the tiled one on the main path's chunk, in turns
    b3_ms = {}
    for k in ("row", "wide", "wide", "row"):
        fn = lk.layout_fused if k == "row" else lk.layout_fused_wide
        b3_ms.setdefault(k, []).append(median_ms(lambda fn=fn: fn(b, n), 20))
    b3_plain_ms = median_ms(lambda: lk.layout_fused_plain(b, n), 2)
    b3_smem, b3_blocks = lk.row_residency(b.shape[1])
    for k, ms in (("layout_fused", b3_ms["row"][0]), ("layout_fused_wide", b3_ms["wide"][0])):
        stats[k] = {
            "max_abs_err": b3_errs[k], "ms": ms, "plain_ms": b3_plain_ms,
            "bound_ms": _nbytes(b, n, *got) / HBM_BYTES_PER_S * 1e3,
            "shape": list(b.shape),
        }
    stats["layout_fused"].update(smem_bytes=b3_smem, blocks_per_sm=b3_blocks,
                                 wide_kernel_ms_same_shape=b3_ms["wide"][0], ms_runs=b3_ms)
    print(f"B3 bit-equal (tolerance 0) at {list(b.shape)}, both kernels; ms in turns "
          f"(row, wide, wide, row): {json.dumps(b3_ms)}; row kernel {b3_smem} B of dynamic "
          f"shared memory, {b3_blocks} blocks per SM", flush=True)
    bnd = got[0]
    state0 = unique_state(eng, b, n, inb, got)
    ids, own_l, own_r, wid = state0
    rows0, rows1, seed = T["merge_rows0"], T["merge_rows1"], T["seed"]
    errs = {"keys": 0, "merge_round_fused": 0}
    for width, rows in STATES:
        if ids.shape[1] != width:
            ids, wid, _bad, (own_l, own_r) = compact(ids, wid, width, (own_l, own_r))
        st_ids, st_wid, st_l, st_r = (x[:rows].contiguous() for x in (ids, wid, own_l, own_r))
        k_got = mk.keys(st_ids, rows0, seed)
        errs["keys"] = max(errs["keys"], _check_equal(
            torch, f"keys {list(st_ids.shape)}", k_got, mk.keys_plain(st_ids, rows0, seed)))
        st = (st_ids, st_l, st_r) + tuple(k_got)
        if rows is None and width == 2048:
            args_2048 = (*st[:3], st_wid, *st[3:], rows0, rows1, seed)
        n_alive = int((st_ids >= 0).sum())
        st, err = b1_rounds(torch, mk, f"merge_round_fused {list(st_ids.shape)}", st,
                            st_wid, rows0, rows1, seed, 2)
        errs["merge_round_fused"] = max(errs["merge_round_fused"], err)
        if rows is None:
            ids, own_l, own_r = st[0], st[1], st[2]
        print(f"B1/B2 bit-equal (tolerance 0) at {list(st_ids.shape)}; alive tokens "
              f"{n_alive} -> {int((st[0] >= 0).sum())} in two rounds", flush=True)

    wide_errs = adversarial_b1(torch, mk)
    for k in ("keys", "merge_round_fused"):
        errs[k] = max(errs[k], wide_errs[k])
    # the wide B1 at the full-width branch's state: the chunk's first 8 rows
    inb8 = inb[:8]
    ids_w = torch.where(inb8, T["byte2id"][b[:8].to(torch.int64)], -1)
    wid_w = torch.where(inb8, torch.cumsum(bnd[:8].int(), 1, dtype=torch.int32) - 1, -1)
    l_w, r_w = init_own(ids_w, T["merge_mclr"])
    args_wide = (ids_w, l_w, r_w, wid_w, *mk.keys(ids_w, rows0, seed), rows0, rows1, seed)
    st = args_wide[:3] + args_wide[4:7]
    wide_before = mk.LAUNCHES["merge_round_fused_wide"]
    for width in (8192, 5120):
        if st[0].shape[1] != width:
            ids_c, wid_w, _bad, (l_c, r_c) = compact(st[0], wid_w, width, st[1:3])
            st = (ids_c, l_c, r_c) + tuple(mk.keys(ids_c, rows0, seed))
        st, err = b1_rounds(torch, mk, f"merge_round_fused_wide {list(st[0].shape)}", st,
                            wid_w, rows0, rows1, seed, 2)
        wide_errs["merge_round_fused_wide"] = max(wide_errs["merge_round_fused_wide"], err)
    wide_launches = mk.LAUNCHES["merge_round_fused_wide"] - wide_before
    print("wide B1 bit-equal (tolerance 0) at the full-width state [8, 8192] and its 5/8 "
          "width [8, 5120]", flush=True)

    # timing at the main path's unique-buffer shape [74, 4096]
    ids, own_l, own_r, wid = state0
    keys0 = mk.keys(ids, rows0, seed)
    # the floor of a launch among back-to-back ones: an empty kernel
    empty_ms = median_ms(lambda: torch.cuda._sleep(0), 20)
    ids_tile = ids[:1, :1024].contiguous()  # one block: the launch and ramp
    stats["keys"] = {
        "max_abs_err": errs["keys"],
        "ms": median_ms(lambda: mk.keys(ids, rows0, seed), 20),
        "one_tile_ms": median_ms(lambda: mk.keys(ids_tile, rows0, seed), 20),
        "plain_ms": median_ms(lambda: mk.keys_plain(ids, rows0, seed), 2),
        "bound_ms": _nbytes(ids, *keys0) / HBM_BYTES_PER_S * 1e3,
        "shape": list(ids.shape),
    }
    args = (ids, own_l, own_r, wid, *keys0, rows0, rows1, seed)
    r_out = mk.merge_round_fused(*args)
    # the row kernel and the wide one on the same inputs, in turns
    b1_ms = {}
    for w, a_ in ((4096, args), (2048, args_2048)):
        for k in ("row", "wide", "wide", "row"):
            fn = mk.merge_round_fused if k == "row" else mk.merge_round_fused_wide
            b1_ms.setdefault(f"{k}_{w}", []).append(
                median_ms(lambda fn=fn, a_=a_: fn(*a_), 20))
    stats["merge_round_fused"] = {
        "max_abs_err": errs["merge_round_fused"],
        "ms": b1_ms["row_4096"][0],
        "plain_ms": median_ms(lambda: mk.merge_round_fused_plain(*args), 2),
        "bound_ms": (_nbytes(*args[:7], *r_out) + _table_bytes(torch, *keys0[:2], rows0))
                    / HBM_BYTES_PER_S * 1e3,
        "shape": list(ids.shape),
        "smem_bytes": mk.row_smem_bytes(ids.shape[1]),
        "wide_kernel_ms_same_shape": b1_ms["wide_4096"][0],
        "ms_runs": b1_ms,
    }
    w_out = mk.merge_round_fused_wide(*args_wide)
    stats["merge_round_fused_wide"] = {
        "max_abs_err": wide_errs["merge_round_fused_wide"],
        "ms": median_ms(lambda: mk.merge_round_fused_wide(*args_wide), 20),
        "plain_ms": median_ms(lambda: mk.merge_round_fused_plain(*args_wide), 2),
        "bound_ms": (_nbytes(*args_wide[:7], *w_out)
                     + _table_bytes(torch, *args_wide[4:6], rows0)) / HBM_BYTES_PER_S * 1e3,
        "shape": list(ids_w.shape),
    }
    print("B1 ms, row kernel against the wide one in turns (row, wide, wide, row): "
          + json.dumps(b1_ms), flush=True)
    torch.cuda.synchronize()

    # ---- 3. the gpt2 path, cold then warm ---------------------------------
    counts = {"layout_fused": lk.LAUNCHES, "layout_fused_wide": lk.LAUNCHES,
              "keys": mk.LAUNCHES,
              "merge_round_fused": mk.LAUNCHES, "merge_round_fused_wide": mk.LAUNCHES,
              "merge_round_standalone": mk.LAUNCHES}
    runs = drive_path(torch, tok, docs, "gpt2", counts)
    zero = [k for k in ("layout_fused", "keys", "merge_round_fused")
            if runs["cold"]["launches"][k] == 0]
    if zero:
        raise SystemExit(f"the gpt2 path never launched {zero}")
    for k in ("merge_round_fused_wide", "layout_fused_wide"):
        if runs["cold"]["launches"][k] != 0:
            raise SystemExit(f"the gpt2 path took {k} on the smoke documents")
    for k in ("layout_fused", "layout_fused_wide", "keys", "merge_round_fused",
              "merge_round_fused_wide"):
        stats[k]["launches"] = runs["cold"]["launches"][k]
        stats[k]["launches_from"] = "gpt2 path, cold"
    # the wide kernels' launches in their own phases (the main path launches them 0 times)
    stats["merge_round_fused_wide"]["own_phase_launches"] = wide_launches
    stats["layout_fused_wide"]["own_phase_launches"] = b3_wide_launches
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
    b, n, inb = first_ascii_chunk(eng3, prepared3)
    bnd, _ = llama3_boundaries(b, inb, T3["cls_table"], ascii_only=True)
    geom = buffer_geometry(b.numel())
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
            chain, err = b1_checked(torch, mk, f"merge_round_fused {list(st_wid.shape)} (llama3)",
                                    (*st, st_wid, *k_got, rows0, rows1, seed))
            errs["merge_round_fused"] = max(errs["merge_round_fused"], err)
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
        "ms": median_ms(lambda: mk.merge_round_standalone(*args4), 20),
        "plain_ms": median_ms(lambda: mk.merge_round_standalone_plain(*args4), 2),
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
    if (cold3["keys"] == 0 or cold3["merge_round_fused"] == 0 or cold3["layout_fused"] != 0
            or cold3["merge_round_fused_wide"] != 0 or cold3["layout_fused_wide"] != 0):
        raise SystemExit(f"llama3 cold launches {cold3}: want B1, B2 > 0 and B3 and "
                         f"the wide B1 = 0")
    numbers["llama3"] = path_numbers(eng3, docs, prepared3, runs3, "llama3")
    numbers["llama3"]["tables_s"] = llama3_build_s
    numbers["llama3"]["b4_rounds_to_completion"] = rounds
    print("numbers " + json.dumps(numbers["llama3"]), flush=True)
    print("kernel_numbers " + json.dumps({
        "kernel_median_ms": {k: s["ms"] for k, s in stats.items()},
        "kernel_bound_us": {k: s["bound_ms"] * 1e3 for k, s in stats.items()},
        "kernel_shapes": {k: s["shape"] for k, s in stats.items()},
        "b1_row_and_wide_ms": stats["merge_round_fused"]["ms_runs"],
        "b1_row_smem_bytes": stats["merge_round_fused"]["smem_bytes"],
        "b3_row_and_wide_ms": stats["layout_fused"]["ms_runs"],
        "b3_row_smem_bytes": stats["layout_fused"]["smem_bytes"],
        "b3_row_blocks_per_sm": stats["layout_fused"]["blocks_per_sm"],
        "b2_one_tile_ms": stats["keys"]["one_tile_ms"],
        "empty_kernel_ms": empty_ms,
    }), flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": TPU_KERNELS[k],
         "launches": s["launches"], "launches_from": s["launches_from"],
         **({"own_phase_launches": s["own_phase_launches"]}
            if "own_phase_launches" in s else {}),
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": None,
         **({"wide_kernel_ms_same_shape": s["wide_kernel_ms_same_shape"]}
            if "wide_kernel_ms_same_shape" in s else {})}
        for k, s in stats.items()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
