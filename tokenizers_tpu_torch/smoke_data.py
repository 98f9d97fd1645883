"""The documents `chip_smoke.py` encodes, and their committed digests.

`build_docs` cuts the corpus into 8 KB documents by the rule of
`bench.py`'s `build_docs`: repeat the text until it exceeds the target,
then take successive DOC_BYTES slices cut back to a UTF-8 character
boundary.  At the default 4 MiB target that is 512 documents: 492 pure
ASCII, which pack into two [256, 8192] chunks, and 20 with multi-byte
characters, which pack into one [32, 8192] chunk.

`data/gpt2_digests.json` and `data/llama3_digests.json` hold one SHA-256
per document of the ids the `tokenizers` wheel gives (special tokens
added) on `tests/fixtures/gpt2/tokenizer.json` and
`tests/fixtures/llama3_128k/tokenizer.json`
(`python -m tokenizers_tpu_torch.data.regen` writes them;
`tests/test_torch_tables.py` re-derives them).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fixtures", "corpus.txt")
CONFIGS = {  # config -> its tokenizer.json
    "gpt2": os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json"),
    "llama3": os.path.join(REPO, "tests", "fixtures", "llama3_128k", "tokenizer.json"),
}
GPT2_JSON = CONFIGS["gpt2"]
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
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


def digests_path(config: str = "gpt2") -> str:
    return os.path.join(DATA, f"{config}_digests.json")


def load_digests(config: str = "gpt2") -> List[str]:
    with open(digests_path(config)) as f:
        return json.load(f)["sha256"]
