"""Host-built tables of the BERT WordPiece device path; port of
`tokenizers_tpu.ops.bert_tables`.

BertNormalizer is a per-char map (`normalizers/bert.py`), so the whole
normalizer is a codepoint -> byte-string table, gathered on the card:
`bert_normalizer_tables` gives a two-stage table (a page index per 256
codepoints, then each page's rows of up to NORM_K output bytes and their
count).  `bert_class_tables` gives BertPreTokenizer's char classes on the
normalized text (whitespace, punctuation, other), two-stage as well.
Both come from the host pipeline's own functions, so host and device
agree byte for byte.

A build walks all 0x110000 codepoints (a few seconds).  The tables are
cached as `.npz` per normalizer configuration in `_cache/` beside this
package (git-ignored; `TOKENIZERS_TPU_TORCH_CACHE` moves it) and in
memory.
"""

from __future__ import annotations

import os

import numpy as np

from ..normalizers.bert import BertNormalizer, is_whitespace
from ..pre_tokenizers.bert import is_punc

MAX_CP = 0x110000
PAGE_BITS = 8
PAGE = 1 << PAGE_BITS
NORM_K = 12  # most output bytes of one input char (checked at build)

BERT_WS = 0
BERT_PUNCT = 1
BERT_OTHER = 2

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_norm_cache: dict = {}
_class_cache = None


def cache_dir() -> str:
    d = os.environ.get("TOKENIZERS_TPU_TORCH_CACHE") or os.path.join(PKG, "_cache")
    os.makedirs(d, exist_ok=True)
    return d


def _codepoints():
    """Every codepoint but the surrogates."""
    return (cp for cp in range(MAX_CP) if not 0xD800 <= cp < 0xE000)


def bert_normalizer_tables(clean_text, handle_chinese_chars, strip_accents, lowercase):
    """-> (s1 int32[MAX_CP >> 8], ob uint8[n_pages * 256, NORM_K],
    ol int8[n_pages * 256]): page of each codepoint's block, then per
    (page, low byte) the output bytes and their count.  ol = -1 marks a
    char whose normalization exceeds NORM_K bytes (the row goes to the
    host; no real configuration has one)."""
    key = (bool(clean_text), bool(handle_chinese_chars), strip_accents, bool(lowercase))
    if key in _norm_cache:
        return _norm_cache[key]
    fname = os.path.join(cache_dir(), "bertnorm_%d%d%s%d_v1.npz" % (
        key[0], key[1], {None: "n", True: "t", False: "f"}[strip_accents], key[3]))
    if os.path.exists(fname):
        z = np.load(fname)
        _norm_cache[key] = (z["s1"], z["ob"], z["ol"])
        return _norm_cache[key]

    char_map = BertNormalizer(*key)._char_map
    cps = np.array(list(_codepoints()), np.int64)
    outs = [char_map(chr(cp)).encode("utf-8") for cp in cps.tolist()]
    lens = np.array([len(o) for o in outs], np.int64)
    fits = lens <= NORM_K
    # every fitting output's bytes at (its codepoint, 0..len-1)
    flat = np.frombuffer(b"".join(o for o, f in zip(outs, fits.tolist()) if f), np.uint8)
    n_fit = lens[fits]
    row = np.repeat(cps[fits], n_fit)
    col = np.arange(len(flat)) - np.repeat(np.cumsum(n_fit) - n_fit, n_fit)
    out_bytes = np.zeros((MAX_CP, NORM_K), np.uint8)
    out_bytes[row, col] = flat
    out_len = np.zeros(MAX_CP, np.int8)
    out_len[cps] = np.where(fits, lens, -1)

    rec = np.concatenate([out_bytes, out_len.astype(np.uint8)[:, None]], axis=1)
    s1, uniq = _dedup_pages(rec.reshape(MAX_CP >> PAGE_BITS, -1))
    uniq = uniq.reshape(-1, NORM_K + 1)
    tables = (s1, np.ascontiguousarray(uniq[:, :NORM_K]), uniq[:, NORM_K].astype(np.int8))
    _save(fname, s1=tables[0], ob=tables[1], ol=tables[2])
    _norm_cache[key] = tables
    return tables


def bert_class_tables():
    """-> (s1 int32[MAX_CP >> 8], s2 int8[n_pages * 256]): BertPreTokenizer's
    class of each codepoint of the normalized text, BERT_WS (splits and
    is removed), BERT_PUNCT (a word of its own) or BERT_OTHER."""
    global _class_cache
    if _class_cache is not None:
        return _class_cache
    fname = os.path.join(cache_dir(), "bertclass_v1.npz")
    if os.path.exists(fname):
        z = np.load(fname)
        _class_cache = (z["s1"], z["s2"])
        return _class_cache
    cls = np.full(MAX_CP, BERT_OTHER, np.int8)
    cls[[cp for cp in _codepoints() if is_punc(chr(cp))]] = BERT_PUNCT
    cls[[cp for cp in _codepoints() if is_whitespace(chr(cp))]] = BERT_WS
    s1, uniq = _dedup_pages(cls.reshape(-1, PAGE).view(np.uint8))
    _class_cache = (s1, uniq.reshape(-1).view(np.int8))
    _save(fname, s1=_class_cache[0], s2=_class_cache[1])
    return _class_cache


def _dedup_pages(pages: np.ndarray):
    """(page index int32[n], distinct pages in byte order) of uint8 rows:
    `np.unique(pages, axis=0, return_inverse=True)`, which the JAX
    package uses, without its slow sort of 4352 rows of kilobytes."""
    keys = [p.tobytes() for p in pages]
    uniq = sorted(set(keys))
    index = {k: i for i, k in enumerate(uniq)}
    s1 = np.array([index[k] for k in keys], np.int32)
    return s1, np.frombuffer(b"".join(uniq), np.uint8).reshape(len(uniq), -1).copy()


def _save(fname, **arrays):
    """Write the cache file whole or not at all (another process may be
    reading or writing it)."""
    tmp = f"{fname}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, fname)
