"""End-to-end seconds of `encode_batch_fast` on the 512 8 KB documents of
`smoke_data.build_docs`, for the gpt2, llama3_128k and bert fixtures, of
any checkout, so that two commits can be compared in turns within one
call on one card (the host pipeline, flagged rows' re-encodes and the
post-processing included).

    python tokenizers_tpu_torch/tools/e2e_ab.py [--root DIR] [--reps N]

DIR (default: the checkout this file is in) holds the
`tokenizers_tpu_torch` that runs; the documents come from this file's own
checkout (`smoke_data.py`, loaded by path), so every commit encodes the
same bytes.  Each rep builds a new tokenizer (its engine and, for bert,
its tables are built before the clock starts), times a cold pass and
then a cached one (`torch.cuda.synchronize()` at both ends), and checks
that every pass gives the first pass's ids.  Prints one JSON line: the
root, the card's name and power limit, and per config the seconds of
every cold and cached pass.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
REPO = os.path.dirname(PKG)
CONFIGS = {"gpt2": "gpt2", "llama3": "llama3_128k", "bert": "bert"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("e2e_ab: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("e2e_ab_smoke_data",
                                                  os.path.join(PKG, "smoke_data.py"))
    data = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(data)
    docs = data.build_docs()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from tokenizers_tpu_torch import Tokenizer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out = {"root": root, "card": smi}
    for name, fixture in CONFIGS.items():
        path = os.path.join(REPO, "tests", "fixtures", fixture, "tokenizer.json")
        runs, first = {"cold": [], "cached": []}, None
        for _ in range(args.reps):
            tok = Tokenizer.from_file(path)
            tok._get_device_engine()
            for kind in ("cold", "cached"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ids = [e.ids for e in tok.encode_batch_fast(docs)]
                torch.cuda.synchronize()
                runs[kind].append(time.perf_counter() - t)
                first = ids if first is None else first
                if ids != first:
                    raise SystemExit(f"e2e_ab {name}: a pass gave other ids than the first")
        out[name] = runs
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
