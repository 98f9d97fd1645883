"""Rows flagged to the host on the JAX bench's gpt2 cold workload.

    python -m tokenizers_tpu_torch.tools.fallback_rows

Packs `bench.py`'s corpus documents (8 KB each, 32 MB as there, cut by
the rule `smoke_data.build_docs` copies) as the engine does, runs every
chunk through `bpe_encode.encode_core` on the card WITHOUT the persistent
word cache (the JAX bench's `gpt2_cold` line: dedup within each chunk
only), and prints one JSON line: rows, rows flagged `row_bad`, their
share, and the seconds the program took (host loop included, synchronised
per chunk), beside the card's name and power limit.  The JAX package
reported its share of flagged rows on the same workload in
`BENCH_r05.json` (`fallback_rows_pct`), so equal counts mean the port
flags the same rows at full scale.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from .. import Tokenizer
from ..ops.bpe_encode import encode_core
from ..ops.packing import pack_batch
from ..smoke_data import GPT2_JSON, build_docs


BENCH_BYTES = 1 << 25  # bench.py's TARGET_BATCH_BYTES


def main() -> None:
    tok = Tokenizer.from_file(GPT2_JSON)
    eng = tok._get_device_engine()
    prepared = [eng._prepare(d) for d in build_docs(BENCH_BYTES)]
    rows = bad = 0
    secs = 0.0
    per_chunk = []
    for buf, lens, _ in pack_batch(prepared):
        b = torch.from_numpy(buf).to(eng.device)
        n = torch.from_numpy(lens).to(eng.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _ids, _ntok, row_bad = encode_core(b, n, eng.tables, cache=None,
                                           ascii_only=eng._is_ascii(buf))
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
        "card": smi, "docs": len(prepared), "bytes": sum(map(len, prepared)),
        "chunks": len(per_chunk), "rows": rows, "bad_rows": bad,
        "bad_rows_pct": 100.0 * bad / rows, "bad_rows_per_chunk": per_chunk,
        "program_s": secs, "program_MBps": sum(map(len, prepared)) / secs / 1e6,
    }))


if __name__ == "__main__":
    main()
