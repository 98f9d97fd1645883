"""A/B of the per-word packing in `bpe_dedup._finish_expand`.

    python -m tokenizers_tpu_torch.tools.per_word_ab [--config gpt2|llama3]

The JAX package packs each unique word's token count and start in buffer
order; when a compaction overflow drops every token of a word, every
later word of the chunk reads the next word's counts.  The port indexes
them by the word's rank instead.  This script runs `fallback_rows` (the
bench's cold workload of the config, on the card) twice: on a temporary
copy of the package with the JAX packing restored, then on the package as
it is, and prints both JSON lines.  The first reproduces the JAX package's count
of flagged rows; the difference is the rows the shift used to flag.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

JAX_PACKING = '''    def per_word(mask, vals):
        (out,), _c = compact_left((vals,), mask, (0,), wrap=True)
        flat = out.reshape(-1)
        if flat.shape[0] < nw_cap:
            flat = torch.cat([flat, flat.new_zeros(nw_cap - flat.shape[0])])
        return flat[:nw_cap]

'''


def _run(cwd: str, config: str) -> str:
    cmd = [sys.executable, "-m", "tokenizers_tpu_torch.tools.fallback_rows",
           "--config", config]
    return subprocess.run(cmd, cwd=cwd, check=True, capture_output=True,
                          text=True, timeout=900).stdout.strip().splitlines()[-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("gpt2", "llama3"), default="gpt2")
    config = ap.parse_args().config
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(PKG, os.path.join(tmp, "tokenizers_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        os.symlink(os.path.join(REPO, "tests"), os.path.join(tmp, "tests"))
        path = os.path.join(tmp, "tokenizers_tpu_torch", "ops", "bpe_dedup.py")
        with open(path) as f:
            src = f.read()
        a = src.index("    def per_word(mask, vals):")
        b = src.index("    tcnt_u = per_word(is_last, k_in)")
        with open(path, "w") as f:
            f.write(src[:a] + JAX_PACKING + src[b:])
        print("jax_packing", _run(tmp, config), flush=True)
    print("port", _run(REPO, config), flush=True)


if __name__ == "__main__":
    main()
