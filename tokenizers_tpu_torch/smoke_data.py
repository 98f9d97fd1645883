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

`first_ascii_chunk` and `unique_state` give the merge loop's first state
at the gpt2 path's unique buffer, where `chip_smoke.py` and
`tools/b1_phases.py` hold and time B1.  `adversarial_case` builds the
edge-case merge layouts on which `chip_smoke.py` and the tests hold the
merge kernels against their plain versions.
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


def first_ascii_chunk(eng, prepared):
    """The first [256, 8192] ASCII chunk of the packed documents `prepared`
    on the card: (bytes int32, lengths, in-bounds mask)."""
    import torch

    from .ops.packing import pack_batch

    buf, lens, _ = next(c for c in pack_batch(prepared)
                        if c[0].shape == (256, 8192) and eng._is_ascii(c[0]))
    b = torch.from_numpy(buf).cuda().to(torch.int32)
    n = torch.from_numpy(lens).cuda()
    inb = torch.arange(b.shape[1], device=b.device)[None, :] < n[:, None]
    return b, n, inb


def unique_state(eng, b, n, inb, layout):
    """The merge loop's first state (ids, own_l, own_r, wid) at the gpt2
    path's unique buffer of the chunk b, from its layout (B3's outputs)."""
    import torch

    from .ops.bpe_dedup import buffer_geometry, dedup_layout, unique_buffer
    from .ops.bpe_merge2 import init_own

    T = eng.tables
    bnd, nxt, h1, h2 = layout
    geom = buffer_geometry(b.numel())
    fits, ops = dedup_layout(b, bnd, inb, n, nxt, T["seed"], geom, hashes=(h1, h2))
    if not fits:
        raise SystemExit("the corpus chunk does not fit its dedup buffer")
    b_u, _uh, inb_u, wid, _we, _up = unique_buffer(ops, b, geom)
    ids = torch.where(inb_u, T["byte2id"][b_u.to(torch.int64)], -1)
    own_l, own_r = init_own(ids, T["merge_mclr"])
    return ids, own_l, own_r, wid


def adversarial_case(seed: int, R: int, C: int, reach: int = 512):
    """A random merge table and a mid-merge [R, C] layout for the merge
    kernels, built to hit the edges of a kernel that gives each thread 4
    contiguous positions (`csrc/merge_round.cu`).  Row r is of kind
    r % 6:

    0. all dead;
    1. one word filling the whole row, with dead positions inside it;
    2. words whose boundaries fall just before, on and after multiples of 4
       and 128 (thread and warp boundaries), with one-token words;
    3. runs of reach - 1, reach and reach + 1 dead positions inside words
       and between them, where they fit (else kind 5);
    4. runs of one self-merging token (equal-rank pair runs of odd and
       even length), next to other words;
    5. random words of 1-12 tokens with random dead positions.

    Odd rows offset their word ids by a large random base (like the ladder's
    global word ordinals); dead positions inside a word keep its word id,
    the row's tail is padding (id and word id -1).  Returns (merges,
    n_ids, ids int32[R, C], wid int32[R, C]), numpy."""
    rng = np.random.default_rng(seed)
    merges = {}
    n_ids = 8
    self_ranks = set(rng.choice(40, size=4, replace=False).tolist())
    selfs = iter(range(4))
    while len(merges) < 120:
        rank = len(merges)
        if rank in self_ranks:
            t = next(selfs)
            pair = (t, t)
        else:
            pair = tuple(int(x) for x in rng.integers(n_ids, size=2))
            if pair in merges or (pair[0] == pair[1] and pair[0] < 4):
                continue  # the self-pairs of 0-3 take the ranks drawn above
        merges[pair] = (rank, n_ids)
        n_ids += 1

    def token():
        return int(rng.integers(8)) if rng.random() < 0.8 else int(rng.integers(n_ids))

    ids = np.full((R, C), -1, np.int32)
    wid = np.full((R, C), -1, np.int32)
    for r in range(R):
        kind = r % 6
        gaps = [g for g in (reach - 1, reach, reach + 1) if 2 * g + 16 < C]
        if kind == 3 and not gaps:
            kind = 5
        end = C if kind == 1 else C - int(rng.integers(0, 6))
        col = w = 0
        if kind == 0:
            continue
        if kind == 1:
            ids[r] = [token() for _ in range(C)]
            ids[r, rng.random(C) < 0.1] = -1
            wid[r] = 0
        elif kind == 2:
            cuts = {m + d for m in range(0, C, 4) for d in (-1, 0, 1)
                    if rng.random() < 0.08}
            cuts |= {m + d for m in range(128, C, 128) for d in (-1, 0, 1)}
            cuts = sorted(c for c in cuts if 0 < c < end)
            starts = [0] + cuts
            for s, e in zip(starts, cuts + [end]):
                ids[r, s:e] = [token() for _ in range(e - s)]
                wid[r, s:e] = w
                w += 1
            ids[r, :end][rng.random(end) < 0.05] = -1
        elif kind == 3:
            while col < end:
                n = int(rng.integers(1, 4))
                g = gaps[int(rng.integers(len(gaps)))] if rng.random() < 0.5 else 0
                m = int(rng.integers(1, 4))
                if col + n + g + m > end:
                    break
                ids[r, col:col + n] = [token() for _ in range(n)]
                ids[r, col + n + g:col + n + g + m] = [token() for _ in range(m)]
                inside = rng.random() < 0.7  # the gap inside the word, or between two
                wid[r, col:col + n + (g if inside else 0)] = w
                w += 0 if inside else 1
                wid[r, col + n + g:col + n + g + m] = w
                col += n + g + m
                w += 1
        else:
            while col < end:
                if kind == 4 and rng.random() < 0.6:
                    word = [int(rng.integers(4))] * int(rng.integers(2, 11))
                else:
                    word = [token() for _ in range(int(rng.integers(1, 13)))]
                word = word[:end - col]
                ids[r, col:col + len(word)] = word
                wid[r, col:col + len(word)] = w
                col += len(word)
                w += 1
            if kind == 5:
                ids[r, rng.integers(0, C, size=max(C // 32, 1))] = -1
        if r % 2:
            wid[r] = np.where(wid[r] >= 0, wid[r] + int(rng.integers(1 << 20)), -1)
    return merges, n_ids, ids, wid
