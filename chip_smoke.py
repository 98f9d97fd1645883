#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`tokenizers_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels of `tokenizers_tpu_torch/csrc/` with nvcc
   (one process per source, all at once) and prints what ptxas reports.
2. Holds each kernel bit for bit against its plain PyTorch version on the
   card, at the main path's shapes: the layout kernel (B3) on a
   [256, 8192] corpus chunk, the keys (B2) and merge-round (B1) kernels on
   the first rounds of that chunk's real [74, 4096] unique buffer, then at
   the compacted widths 2560 and 2048 and on a ladder-sized [37, 2048]
   slice.  Times each kernel and its plain version with CUDA events.
3. Drives the main path: gpt2 `Tokenizer.encode_batch_fast` on 512 8 KB
   corpus documents (two [256, 8192] ASCII chunks and one [32, 8192]
   chunk of the documents with multi-byte characters), cold and then on
   the warm word cache, with every kernel's launch count set to 0 just
   before the cold run and read just after it.  Every document's ids must
   match its committed SHA-256 (`tokenizers_tpu_torch/data/`).
4. Prints a line of numbers, the per-kernel JSON line, the card's name and
   power limit, and last `{"ok": true, "device": {...}}`.

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
GPT2 = os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TPU_KERNELS = {  # file:line of the `pallas_call` each kernel replaces
    "layout_fused": "tokenizers_tpu/ops/layout_pallas.py:176",
    "keys": "tokenizers_tpu/ops/merge_pallas.py:258",
    "merge_round_fused": "tokenizers_tpu/ops/merge_pallas.py:283",
}
SOURCES = {
    "layout_fused": "tokenizers_tpu_torch/csrc/layout.cu",
    "keys": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_fused": "tokenizers_tpu_torch/csrc/merge_round.cu",
}


def _median_ms(torch, fn, launches):
    """Milliseconds per call: CUDA events around `launches` back-to-back
    calls, after two warm-up calls; the median of five such runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def _check_equal(torch, name, got, want):
    """Bit-for-bit equality of two output tuples; returns max |diff|."""
    err = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise SystemExit(f"{name}: output {k} differs from the plain version")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops import engine_base, kernel_build
    from tokenizers_tpu_torch.ops import layout_kernels as lk
    from tokenizers_tpu_torch.ops import merge_kernels as mk
    from tokenizers_tpu_torch.ops.bpe_dedup import buffer_geometry, dedup_layout, unique_buffer
    from tokenizers_tpu_torch.ops.bpe_merge2 import compact, init_own
    from tokenizers_tpu_torch.ops.packing import pack_batch
    from tokenizers_tpu_torch.smoke_data import build_docs, ids_digest, load_digests

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

    # ---- 2. every kernel against its plain version ------------------------
    tok = Tokenizer.from_file(GPT2)
    eng = tok._get_device_engine()
    T = eng.tables
    docs = build_docs()
    prepared = [eng._prepare(d) for d in docs]
    chunks = pack_batch(prepared)
    buf, lens, _ = next(c for c in chunks if c[0].shape == (256, 8192) and eng._is_ascii(c[0]))
    b = torch.from_numpy(buf).cuda().to(torch.int32)
    n = torch.from_numpy(lens).cuda()
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
    inb = torch.arange(b.shape[1], device=b.device)[None, :] < n[:, None]
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
    for width, rows in ((4096, None), (2560, None), (2048, None), (2048, 37)):
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
        "bound_ms": _nbytes(*args[:7], rows0, rows1, *r_out) / HBM_BYTES_PER_S * 1e3,
        "shape": list(ids.shape),
    }
    torch.cuda.synchronize()

    # ---- 3. the main path, cold then warm ---------------------------------
    counts = {"layout_fused": lk.LAUNCHES, "keys": mk.LAUNCHES, "merge_round_fused": mk.LAUNCHES}
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
    nbytes = sum(len(p) for p in prepared)
    digests = load_digests()
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
            raise SystemExit(f"{run}: {len(bad)} documents differ from their digests: {bad[:10]}")
        runs[run] = dict(secs=secs, program_s=program_s[-1], launches=launches,
                         **engine_base.STATS.snapshot())
        if run == "cold":
            zero = [k for k, v in launches.items() if v == 0]
            if zero:
                raise SystemExit(f"the main path never launched {zero}")
            for k in stats:
                stats[k]["launches"] = launches[k]

    numbers = {
        "docs": len(docs), "bytes": nbytes,
        "chunks": [list(c[0].shape) + [bool(eng._is_ascii(c[0]))] for c in chunks],
        **{f"{run}_MBps": nbytes / r["secs"] / 1e6 for run, r in runs.items()},
        **{f"{run}_program_MBps": nbytes / r["program_s"] / 1e6 for run, r in runs.items()},
        **{f"{run}_bad_row_fraction": r["bad_row_fraction"] for run, r in runs.items()},
        **{f"{run}_launches": r["launches"] for run, r in runs.items()},
        "patched_words": runs["cold"]["patched_words"],
        "digests_matched": len(docs),
        "kernel_median_ms": {k: s["ms"] for k, s in stats.items()},
        "kernel_bound_us": {k: s["bound_ms"] * 1e3 for k, s in stats.items()},
        "kernel_shapes": {k: s["shape"] for k, s in stats.items()},
    }
    print("numbers " + json.dumps(numbers), flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": TPU_KERNELS[k],
         "launches": s["launches"], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
         "library_ms": None}
        for k, s in stats.items()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
