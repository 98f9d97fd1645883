"""The documents `chip_smoke.py` encodes, and their committed digests.

`build_docs` cuts the corpus into 8 KB documents by the rule of
`bench.py`'s `build_docs`: repeat the text until it exceeds the target,
then take successive DOC_BYTES slices cut back to a UTF-8 character
boundary.  At the default 4 MiB target that is 512 documents: 492 pure
ASCII, which pack into two [256, 8192] chunks, and 20 with multi-byte
characters, which pack into one [32, 8192] chunk.

`data/gpt2_digests.json` holds one SHA-256 per document of the ids the
`tokenizers` wheel gives on `tests/fixtures/gpt2/tokenizer.json`
(`python -m tokenizers_tpu_torch.data.regen` writes it;
`tests/test_torch_tables.py` re-derives it).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fixtures", "corpus.txt")
GPT2_JSON = os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json")
DIGESTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "gpt2_digests.json"
)
DOC_BYTES = 8 * 1024
TARGET_BYTES = 4 << 20


def build_docs(target: int = TARGET_BYTES, doc_bytes: int = DOC_BYTES) -> List[str]:
    with open(CORPUS, encoding="utf-8") as f:
        text = f.read()
    while len(text.encode("utf-8")) < target * 1.1:
        text += text
    data = text.encode("utf-8")
    docs = []
    total = 0
    off = 0
    while off + doc_bytes <= len(data) and total < target:
        chunk = data[off : off + doc_bytes]
        while chunk and (chunk[-1] & 0xC0) == 0x80:  # cut at UTF-8 boundary
            chunk = chunk[:-1]
        if chunk and chunk[-1] >= 0xC0:  # dangling lead byte
            chunk = chunk[:-1]
        docs.append(chunk.decode("utf-8"))
        total += len(chunk)
        off += len(chunk)
    return docs


def ids_digest(ids: Sequence[int]) -> str:
    return hashlib.sha256(np.asarray(ids, dtype="<i4").tobytes()).hexdigest()


def load_digests() -> List[str]:
    with open(DIGESTS) as f:
        return json.load(f)["sha256"]
