"""Rows flagged to the host on the JAX bench's cold workload.

    python -m tokenizers_tpu_torch.tools.fallback_rows [--config gpt2|llama3]

Packs `bench.py`'s corpus documents (8 KB each, 32 MB as there, cut by
the rule `smoke_data.build_docs` copies) as the engine does, runs every
chunk through `bpe_encode.encode_core` on the card WITHOUT the persistent
word cache (the JAX bench's `gpt2_cold` and `llama3` lines: dedup within
each chunk only), and prints one JSON line: rows, rows flagged `row_bad`,
their share, and the seconds the program took (host loop included,
synchronised per chunk), beside the card's name and power limit.  The JAX
package reported its share of flagged rows on the same workload in
`BENCH_r05.json` (`fallback_rows_pct`: 14.89 for gpt2, 0.23 for llama3),
so equal counts mean the port flags the same rows at full scale.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .. import Tokenizer
from ..ops.bpe_encode import encode_core
from ..ops.packing import pack_batch
from ..smoke_data import CONFIGS, build_docs

BENCH_BYTES = 1 << 25  # bench.py's TARGET_BATCH_BYTES


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="gpt2")
    config = ap.parse_args().config
    tok = Tokenizer.from_file(CONFIGS[config])
    eng = tok._get_device_engine()
    if eng is None:
        raise SystemExit(f"{config}: no device engine")
    T = eng.tables
    prepared = [eng._prepare(d) for d in build_docs(BENCH_BYTES)]
    rows = bad = 0
    secs = 0.0
    per_chunk = []
    for buf, lens, _ in pack_batch(prepared):
        b = torch.from_numpy(buf).to(eng.device)
        n = torch.from_numpy(lens).to(eng.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _ids, _ntok, row_bad = encode_core(b, n, T, cache=None,
                                           ascii_only=eng._is_ascii(buf),
                                           boundary=T["boundary"],
                                           whole_word=T["whole_word"])
        flagged = int(row_bad.sum())
        secs += time.perf_counter() - t
        rows += row_bad.numel()
        bad += flagged
        per_chunk.append(flagged)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "config": config, "card": smi, "docs": len(prepared),
        "bytes": sum(map(len, prepared)), "chunks": len(per_chunk), "rows": rows,
        "bad_rows": bad, "bad_rows_pct": 100.0 * bad / rows,
        "bad_rows_per_chunk": per_chunk, "program_s": secs,
        "program_MBps": sum(map(len, prepared)) / secs / 1e6,
    }))


if __name__ == "__main__":
    main()
