"""Regenerate the committed data files of this directory.

    python -m tokenizers_tpu_torch.data.regen

* `char_class.npz`: the two-stage codepoint -> class table, derived from
  the `regex` module's \\p{L} and \\p{N} (the classes Oniguruma uses).
* `gpt2_digests.json`, `llama3_digests.json`, `bert_digests.json`:
  per-document SHA-256 of the ids that the `tokenizers` wheel gives for
  `smoke_data.build_docs()` on the gpt2, llama3_128k and bert fixtures;
  `gpt2_long_digests.json` for the documents of
  `smoke_data.long_parts()`, in order, on gpt2; `bert_long_digests.json`
  for the long documents (a), `long_parts()["long"]`, on bert.
* `gpt2_offsets_digests.json`, `llama3_offsets_digests.json`,
  `bert_offsets_digests.json`: per document, `smoke_data.offsets_digest`
  of the wheel's `encode_batch` (ids, char offsets, word ids) on the same
  documents; `gpt2_long_offsets_digests.json` and
  `bert_long_offsets_digests.json` for the long documents (a) on gpt2 and
  bert.

Both references are optional dependencies: they are imported by name here
only, so the package itself never needs them.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

from ..ops.unicode_tables import (
    CLS_L,
    CLS_N,
    CLS_SP,
    CLS_WS,
    MAX_CP,
    PAGE_SIZE,
    TABLE_PATH,
)
from ..smoke_data import (
    CONFIGS, build_docs, digests_path, ids_digest, long_parts, offsets_digest,
)

# Oniguruma \s
WS_CODEPOINTS = (
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B))
    + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)


def class_tables():
    """(stage1 int32, stage2 int8), deduplicating identical pages."""
    re_mod = importlib.import_module("regex")
    cls = np.zeros(MAX_CP, dtype=np.int8)
    cps = np.concatenate(
        [np.arange(0, 0xD800, dtype=np.int64), np.arange(0xE000, MAX_CP, dtype=np.int64)]
    )
    all_chars = "".join(map(chr, cps.tolist()))
    for pat, value in ((r"\p{L}", CLS_L), (r"\p{N}", CLS_N)):
        hits = re_mod.compile(pat, re_mod.V0).findall(all_chars)
        cls[np.array([ord(c) for c in hits], dtype=np.int64)] = value
    cls[np.array(WS_CODEPOINTS, dtype=np.int64)] = CLS_WS
    cls[0x20] = CLS_SP
    uniq, stage1 = np.unique(cls.reshape(-1, PAGE_SIZE), axis=0, return_inverse=True)
    return stage1.reshape(-1).astype(np.int32), uniq.reshape(-1).astype(np.int8)


def wheel_digests(config: str = "gpt2", docs=None):
    wheel = importlib.import_module("tokenizers")
    ref = wheel.Tokenizer.from_file(CONFIGS[config])
    encs = ref.encode_batch_fast(build_docs() if docs is None else docs,
                                 add_special_tokens=True)
    return [ids_digest(e.ids) for e in encs]


def wheel_offsets_digests(config: str = "gpt2", docs=None):
    wheel = importlib.import_module("tokenizers")
    ref = wheel.Tokenizer.from_file(CONFIGS[config])
    encs = ref.encode_batch(build_docs() if docs is None else docs, add_special_tokens=True)
    return [offsets_digest(e) for e in encs]


def main():
    stage1, stage2 = class_tables()
    np.savez_compressed(TABLE_PATH, stage1=stage1, stage2=stage2)
    print("wrote", TABLE_PATH, os.path.getsize(TABLE_PATH), "bytes")
    digests = {config: wheel_digests(config) for config in CONFIGS}
    digests["gpt2_long"] = wheel_digests("gpt2", sum(long_parts().values(), []))
    digests["bert_long"] = wheel_digests("bert", long_parts()["long"])
    for config in CONFIGS:
        digests[f"{config}_offsets"] = wheel_offsets_digests(config)
    for config in ("gpt2", "bert"):
        digests[f"{config}_long_offsets"] = wheel_offsets_digests(config, long_parts()["long"])
    for name, sha in digests.items():
        with open(digests_path(name), "w") as f:
            json.dump({"sha256": sha}, f, indent=0)
            f.write("\n")
        print("wrote", digests_path(name))


if __name__ == "__main__":
    main()
