"""Regenerate the committed data files of this directory.

    python -m tokenizers_tpu_torch.data.regen [--retrain] [--recipes] [--uprops]
                                              [--host-pipelines] [--graphemes]
                                              [--charsmap] [--unigram-round-trip]
                                              [--jax-api]

(`--recipes`, `--uprops`, `--host-pipelines`, `--graphemes`, `--charsmap`,
`--unigram-round-trip`, `--jax-api`: that file alone.)

* `char_class.npz`: the two-stage codepoint -> class table, derived from
  the `regex` module's \\p{L} and \\p{N} (the classes Oniguruma uses).
* `uprops.npz`: the code-point ranges of every General_Category value
  and group, `Alphabetic`, `White_Space` and the scripts of
  `UnicodeScripts` (`uprops.table_names`), each found as the runs of
  the `regex` module's class over a string of every code point.
* `host_pipelines_digests.json` (`chip_smoke.py` phase 16): for each
  pipeline of `smoke_data.host_pipelines()`, the wheel's ids digests of
  `encode_batch_fast` and `smoke_data.offsets_digest` of `encode_batch`
  on the documents that phase encodes with it.
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

* `char_bpe.json`, `sp_bpe.json`, `wordlevel.json`: the char-level
  phase's tokenizers, trained by the wheel from `tests/fixtures/corpus.txt`
  (`CharBPETokenizer()`, `SentencePieceBPETokenizer(fuse_unk=True)` and a
  WordLevel with Sequence[NFD, StripAccents, Lowercase] and Whitespace,
  each at vocab_size 30,000) only where the file is missing or with
  `--retrain`: the wheel's suffix-BPE trainer differs from process to
  process, so the committed files are the source.  Their digests (ids of
  the 8 KB documents for each and for `smoke_data.spm_bf_json()`, of the
  long documents (a) for sp_bpe, and offsets digests of the 8 KB
  documents for the three files) follow the files.
* `train_digests.json`: for each run of `smoke_data.TRAIN_RUNS`, the
  SHA-256 of the merges and of the vocab, and their sizes, that the
  wheel's BpeTrainer trains from the Whitespace words of the corpus
  lines (`bench.py`'s `train` config at 512, and the whole corpus at
  16,000: the dense trainer's widest run).
* `unigram_train.json`: the wheel's UnigramTrainer at
  `smoke_data.UNIGRAM_TRAIN` (vocab 8,000, `<unk>`) on the `unigram`
  fixture's recipe (`smoke_data.recipe_json`), fed the lines of the
  corpus's first 1 MB: its settings and [piece, score] list.
* `unigram_round_trip_digests.json` (`chip_smoke.py` phase 17 (c)): the
  ids digests of the 8 KB documents that the wheel gives with the model
  of `unigram_train.json` held exactly in memory, and after its own
  `to_str` and `from_str` (`wheel_unigram_round_trip`).
* `decode_digests.json`: per tokenizer of `smoke_data.DECODE_CONFIGS`,
  the text digests of the wheel's `decode_batch` of its own ids of the 8
  KB documents, with and without `skip_special_tokens`, and for
  `STREAM_CONFIGS` the digests of the wheel's `DecodeStream` steps over
  the first `STREAM_DOCS` documents.
* `recipes_digests.json` (`chip_smoke.py` phase 15): the wheel's
  `ByteLevelBPETokenizer.from_file` on the gpt2 fixture's model written
  by the port's `BPE.save`, with `<|endoftext|>` special,
  `smoke_data.RECIPE_TOKEN` added (lstrip, rstrip) and
  `RECIPE_SETTINGS` (truncation at 1,024, stride 128; padding to a
  multiple of 8): per input of the 8 KB documents and `RECIPE_EXTRA`, the
  `recipe_digest` of `encode_batch_fast` and the `offsets_digest` of
  `encode_batch`, and its `to_str` digest; the `to_str` digest of each
  of `TO_STR_CONFIGS`; `BertWordPieceTokenizer` on the bert fixture's
  `vocab.txt` written by `WordPiece.save`, with `BERT_PAIR_SETTINGS`: the
  `recipe_digest` of `encode_batch` of `bert_pairs`; and
  `ByteLevelBPETokenizer().train_from_iterator` at `RECIPE_TRAIN` on the
  lines of the corpus's first 1 MB: its `to_str` digest and the ids
  digests of its `encode_batch_fast` of the 8 KB documents.
* `unigram_digests.json`, `unigram_bf_digests.json` (ids of the 8 KB
  documents), `unigram_long_digests.json` (the long documents (a)) and
  `unigram_offsets_digests.json`, `unigram_bf_offsets_digests.json`
  (offsets digests of the 8 KB documents), on the fixtures of
  `smoke_data.UNIGRAM_CONFIGS`.
* `jax_api_digests.json` (`chip_smoke.py` phase 18): that phase's
  trained tokenizer (`smoke_data.jax_api_tokenizer`) run by the port
  itself on the CPU (`set_default_device("cpu")`): its `to_str` digest,
  the ids digests of its `encode_batch_fast` of the 8 KB documents, and
  `smoke_data.jax_api_tokens` of its model.

Both references are optional dependencies: they are imported by name here
only, so the package itself never needs them.
"""

from __future__ import annotations

import importlib
import json
import os
import struct
import sys
import unicodedata
from collections import deque

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
from ..ops.wordlevel_encode import class_table_path
from ..smoke_data import (
    BERT_PAIR_SETTINGS, CHAR_CONFIGS, CONFIGS, CORPUS, DATA, DECODE_CONFIGS, RECIPE_EXTRA,
    JAX_API_TRAIN, RECIPE_SETTINGS, RECIPE_TOKEN, RECIPE_TRAIN, STREAM_CONFIGS, STREAM_DOCS,
    TO_STR_CONFIGS, TRAIN_RUNS, UNIGRAM_CONFIGS, UNIGRAM_TRAIN, apply_settings, bert_pairs,
    build_docs, config_json, digests_path, ids_digest, jax_api_tokenizer, jax_api_tokens,
    load_unigram_train, long_parts, merges_digest, offsets_digest, recipe_digest, recipe_json,
    stream_digest, text_digest, train_lines, vocab_digest,
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


def wordlevel_class_table(kind: str):
    """(s1 int32, s2 int8) of the "whitespace" or "whitespace_split"
    pre-split: \\w per the `regex` module (V0) against the rest, and
    whitespace; the construction of the JAX package's
    `wordlevel_class_tables`."""
    from ..ops.wordlevel_encode import WL_A, WL_B, WL_WS

    cls = np.full(MAX_CP, WL_A, np.int8)
    if kind == "whitespace":
        re_mod = importlib.import_module("regex")
        cps = np.concatenate(
            [np.arange(0, 0xD800, dtype=np.int64), np.arange(0xE000, MAX_CP, dtype=np.int64)])
        hits = re_mod.compile(r"\w", re_mod.V0).findall("".join(map(chr, cps.tolist())))
        cls[:] = WL_B
        cls[np.array([ord(c) for c in hits], dtype=np.int64)] = WL_A
    cls[np.array(WS_CODEPOINTS, dtype=np.int64)] = WL_WS
    uniq, s1 = np.unique(cls.reshape(-1, PAGE_SIZE), axis=0, return_inverse=True)
    return s1.reshape(-1).astype(np.int32), uniq.reshape(-1).astype(np.int8)


def uprops_tables():
    """{name: int32 [n, 2] half-open ranges} of every `uprops.table_names`
    entry, from the `regex` module's class over every code point."""
    from ..uprops import MAX_CP, regex_class, table_names

    re_mod = importlib.import_module("regex")
    every = "".join(map(chr, range(MAX_CP)))
    out = {}
    for name in table_names():
        runs = [m.span() for m in re_mod.finditer("(?:%s)+" % regex_class(name), every)]
        out[name] = np.array(runs, np.int32).reshape(-1, 2)
    return out


def write_uprops():
    from ..uprops import UPROPS_PATH

    tables = uprops_tables()
    np.savez_compressed(UPROPS_PATH, **{k.replace(":", "_"): v for k, v in tables.items()})
    print("wrote", UPROPS_PATH, os.path.getsize(UPROPS_PATH), "bytes")


def grapheme_props():
    """uint8 [MAX_CP]: `graphemes.table`'s byte of every code point, from
    the `regex` module's Grapheme_Cluster_Break, Extended_Pictographic and
    Indic_Conjunct_Break classes over every code point."""
    from ..graphemes import EXT_PICT, GCB, INCB
    from ..uprops import MAX_CP

    re_mod = importlib.import_module("regex")
    every = "".join(map(chr, range(MAX_CP)))
    props = np.zeros(MAX_CP, np.uint8)

    def runs(cls):
        return [m.span() for m in re_mod.finditer("(?:%s)+" % cls, every)]

    for i, name in enumerate(GCB[1:], 1):
        for a, b in runs("\\p{Grapheme_Cluster_Break=%s}" % name):
            props[a:b] |= i
    for a, b in runs("\\p{Extended_Pictographic}"):
        props[a:b] |= EXT_PICT
    for i, name in enumerate(INCB[1:], 1):
        for a, b in runs("\\p{Indic_Conjunct_Break=%s}" % name):
            props[a:b] |= i << 5
    return props


def write_graphemes():
    from ..graphemes import GRAPHEMES_PATH

    np.savez_compressed(GRAPHEMES_PATH, props=grapheme_props())
    print("wrote", GRAPHEMES_PATH, os.path.getsize(GRAPHEMES_PATH), "bytes")


def double_array(keys):
    """darts-clone's double array (the reader of `spm_precompiled` and
    `normalizers.precompiled.DoubleArray`) of `keys`, {bytes: value <
    2^31}, as uint32 units.  Each node's children sit at `base ^ label`,
    its value at `base ^ 0` with the leaf bit (bit 31); a unit holds its
    label (bits 0-7), has-leaf (bit 8) and `offset = own index ^ base`
    (bits 10-30).  No two nodes share a base, so a byte read from one node
    never matches a label set under another; a unit no node uses gets the
    label of a base no node of its block uses, which no byte matches."""
    trie = {}
    for key, value in keys.items():
        node = trie
        for c in key:
            node = node.setdefault(c, {})
        node[None] = value
    units = {0: 0}
    free = [set(range(1, 256))]  # the free slots of each 256-unit block; the root is 0
    used = [set()]  # the low bytes of the bases in use in each block
    todo = deque([(0, trie)])
    while todo:
        index, node = todo.popleft()
        labels = [0 if c is None else c for c in node]
        base = None
        for b in range(len(free)):
            for slot in sorted(free[b]):
                e = slot ^ labels[0]
                if e not in used[b] and all(e ^ x in free[b] for x in labels):
                    base = (b << 8) | e
                    break
            if base is not None:
                break
        if base is None:
            free.append(set(range(256)))
            used.append(set())
            base = (len(free) - 1) << 8 | labels[0]
        b = base >> 8
        used[b].add(base & 0xFF)
        if index ^ base >= 1 << 21:
            raise ValueError("double array too large for 21-bit offsets")
        units[index] |= (index ^ base) << 10
        for c, child in node.items():
            label = 0 if c is None else c
            free[b].discard((base ^ label) & 0xFF)
            if c is None:
                units[base] = child | (1 << 31)
                units[index] |= 1 << 8
            else:
                units[base ^ label] = label
                todo.append((base ^ label, child))
    out = np.zeros(len(free) << 8, np.uint32)
    for b in range(len(free)):
        spare = next((e for e in range(256) if e not in used[b]), 0)
        for i in range(b << 8, (b + 1) << 8):
            out[i] = units[i] if i in units else (i ^ spare) & 0xFF
    return out


def precompiled_charsmap(rules):
    """The `precompiled_charsmap` bytes of {key: normalized} (SentencePiece's
    format: the trie's size in bytes, little endian, the double array,
    then each normalized string with a NUL after it)."""
    blob, at, keys = bytearray(), {}, {}
    for key, norm in rules.items():
        if norm not in at:
            at[norm] = len(blob)
            blob += norm.encode("utf-8") + b"\0"
        keys[key.encode("utf-8")] = at[norm]
    units = double_array(keys)
    return struct.pack("<I", units.nbytes) + units.astype("<u4").tobytes() + bytes(blob)


CHARSMAP_EXTRA = {  # multi-char keys of `charsmap_nfkc.bin` beside the NFKC map
    "\u00a9\ufe0f": "\u00a9",      # copyright sign + VS16: 5 bytes, one grapheme
    "1\u20e3": "1",                  # keycap one: 4 bytes
    "\u1100\u1161": "\uac00",      # a Hangul L V grapheme of 6 bytes: never looked up whole
    "\U0001f44d\U0001f3fb": "\U0001f44d",  # thumbs up + skin tone: 8 bytes
    "\U0001f1fa\U0001f1f8": "US",   # a flag: 8 bytes
    "k\u0301\u0323": "\u1e33\u0301",  # 5 bytes, a key under which "k\u0301" is no key
}


def charsmap_nfkc_rules():
    """{key: normalized}: every code point whose NFKC form differs from
    itself (the shape of SentencePiece's `nmt_nfkc` rule set), every
    letter + combining mark pair that NFC composes, and CHARSMAP_EXTRA."""
    rules = {}
    for cp in range(0x110000):
        if 0xD800 <= cp < 0xE000:
            continue
        c = chr(cp)
        n = unicodedata.normalize("NFKC", c)
        if n != c:
            rules[c] = n
    for base in "aeiounycgzsAEIOUNYCGZS":
        for mark in "\u0300\u0301\u0302\u0303\u0308\u030a\u030c\u0327":
            n = unicodedata.normalize("NFC", base + mark)
            if len(n) == 1:
                rules[base + mark] = n
    rules.update(CHARSMAP_EXTRA)
    return rules


def write_charsmap():
    from ..normalizers.precompiled import CHARSMAP_NFKC_PATH

    data = precompiled_charsmap(charsmap_nfkc_rules())
    with open(CHARSMAP_NFKC_PATH, "wb") as f:
        f.write(data)
    print("wrote", CHARSMAP_NFKC_PATH, len(data), "bytes")


def wheel_host_pipelines_digests():
    """{pipeline: {"fast": [...], "offsets": [...]}} of the wheel on each of
    `smoke_data.host_pipelines()`'s tokenizers and its documents."""
    from ..smoke_data import host_pipeline_docs, host_pipelines

    wheel = importlib.import_module("tokenizers")
    out = {}
    for name, s in host_pipelines().items():
        tok = wheel.Tokenizer.from_str(s)
        docs = host_pipeline_docs(name)
        out[name] = {
            "fast": [ids_digest(e.ids) for e in tok.encode_batch_fast(docs)],
            "offsets": [offsets_digest(e) for e in tok.encode_batch(docs)],
        }
    return out


def write_host_pipelines_digests():
    path = os.path.join(DATA, "host_pipelines_digests.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(wheel_host_pipelines_digests(), f, indent=0)
        f.write("\n")
    print("wrote", path)


def train_char_configs(retrain: bool = False):
    """Train and write the CHAR_CONFIGS tokenizers that are missing (all
    with `retrain`)."""
    wheel = importlib.import_module("tokenizers")
    for name, path in CHAR_CONFIGS.items():
        if os.path.exists(path) and not retrain:
            continue
        if name == "char_bpe":
            tok = wheel.CharBPETokenizer()
            tok.train([CORPUS], vocab_size=30000, show_progress=False)
        elif name == "sp_bpe":
            tok = wheel.SentencePieceBPETokenizer(fuse_unk=True)
            tok.train([CORPUS], vocab_size=30000, special_tokens=["<unk>"], show_progress=False)
        else:
            tok = wheel.Tokenizer(wheel.models.WordLevel(unk_token="[UNK]"))
            n = wheel.normalizers
            tok.normalizer = n.Sequence([n.NFD(), n.StripAccents(), n.Lowercase()])
            tok.pre_tokenizer = wheel.pre_tokenizers.Whitespace()
            tok.train([CORPUS], wheel.trainers.WordLevelTrainer(
                vocab_size=30000, special_tokens=["[UNK]"], show_progress=False))
        with open(path, "w", encoding="utf-8") as f:
            f.write(tok.to_str())
        print("wrote", path, os.path.getsize(path), "bytes")


def _wheel(config: str):
    return importlib.import_module("tokenizers").Tokenizer.from_str(config_json(config))


def wheel_digests(config: str = "gpt2", docs=None):
    encs = _wheel(config).encode_batch_fast(build_docs() if docs is None else docs,
                                            add_special_tokens=True)
    return [ids_digest(e.ids) for e in encs]


def wheel_offsets_digests(config: str = "gpt2", docs=None):
    encs = _wheel(config).encode_batch(build_docs() if docs is None else docs,
                                       add_special_tokens=True)
    return [offsets_digest(e) for e in encs]


def wheel_train_digests():
    """{run: merges and vocab digests and sizes} of the wheel's BpeTrainer
    on each of TRAIN_RUNS."""
    wheel = importlib.import_module("tokenizers")
    out = {}
    for name, (nchars, vocab_size) in TRAIN_RUNS.items():
        tok = wheel.Tokenizer(wheel.models.BPE())
        tok.pre_tokenizer = wheel.pre_tokenizers.Whitespace()
        tok.train_from_iterator(train_lines(nchars), wheel.trainers.BpeTrainer(
            vocab_size=vocab_size, show_progress=False))
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in json.loads(tok.to_str())["model"]["merges"]]
        vocab = tok.get_vocab()
        out[name] = {"merges_sha256": merges_digest(merges), "n_merges": len(merges),
                     "vocab_sha256": vocab_digest(vocab), "vocab_size": len(vocab)}
    return out


def wheel_unigram_train():
    """{settings, "vocab": [[piece, score], ...]} of the wheel's
    UnigramTrainer at UNIGRAM_TRAIN on the unigram recipe.  The wheel's
    training is not bit-for-bit repeatable (its scores move in the last
    ulps from run to run), so the committed file is the source."""
    wheel = importlib.import_module("tokenizers")
    tok = wheel.Tokenizer.from_str(recipe_json("unigram"))
    tok.train_from_iterator(train_lines(UNIGRAM_TRAIN["chars"]), wheel.trainers.UnigramTrainer(
        vocab_size=UNIGRAM_TRAIN["vocab_size"], special_tokens=["<unk>"], unk_token="<unk>",
        show_progress=False))
    model = json.loads(tok.to_str())["model"]
    return {**UNIGRAM_TRAIN, "unk_id": model["unk_id"], "vocab": model["vocab"]}


def wheel_unigram_round_trip():
    """{"trained": [...], "round_trip": [...]}: the ids digests of the 8 KB
    documents that the wheel gives with the model of `unigram_train.json`
    held exactly in memory (`models.Unigram` of its pieces and scores, on
    the unigram recipe with `<unk>` special, as training leaves it), and
    with that model after the wheel's own `to_str` and `from_str` (whose
    parse of the scores is lossy)."""
    wheel = importlib.import_module("tokenizers")
    want = load_unigram_train()
    tok = wheel.Tokenizer.from_str(recipe_json("unigram"))
    tok.model = wheel.models.Unigram([tuple(p) for p in want["vocab"]], want["unk_id"], False)
    tok.add_special_tokens(["<unk>"])
    back = wheel.Tokenizer.from_str(tok.to_str())
    docs = build_docs()
    return {name: [ids_digest(e.ids) for e in t.encode_batch_fast(docs, add_special_tokens=True)]
            for name, t in (("trained", tok), ("round_trip", back))}


def write_unigram_round_trip():
    path = os.path.join(DATA, "unigram_round_trip_digests.json")
    with open(path, "w") as f:
        json.dump(wheel_unigram_round_trip(), f, indent=0)
        f.write("\n")
    print("wrote", path)


def wheel_decode_digests():
    """{config: {"skip": [...], "keep": [...], "stream": [...]}}: text
    digests of the wheel's decode of its own ids of the 8 KB documents."""
    wheel = importlib.import_module("tokenizers")
    docs = build_docs()
    out = {}
    for config in DECODE_CONFIGS:
        tok = _wheel(config)
        ids = [e.ids for e in tok.encode_batch_fast(docs, add_special_tokens=True)]
        out[config] = {key: [text_digest(s) for s in tok.decode_batch(ids, skip_special_tokens=skip)]
                       for key, skip in (("skip", True), ("keep", False))}
        if config in STREAM_CONFIGS:
            streams = []
            for doc_ids in ids[:STREAM_DOCS]:
                ds = wheel.decoders.DecodeStream(skip_special_tokens=True)
                streams.append(stream_digest(ds.step(tok, i) for i in doc_ids))
            out[config]["stream"] = streams
    return out


def wheel_recipes_digests():
    """The digests of `recipes_digests.json` (the module docstring)."""
    import tempfile

    from ..tokenizer import Tokenizer

    wheel = importlib.import_module("tokenizers")
    recipes = importlib.import_module("tokenizers.implementations")
    docs = build_docs()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        files = Tokenizer.from_str(config_json("gpt2"), device="cpu").model.save(d)
        tok = recipes.ByteLevelBPETokenizer.from_file(*files)
        tok.add_special_tokens(["<|endoftext|>"])
        tok.add_tokens([wheel.AddedToken(RECIPE_TOKEN, lstrip=True, rstrip=True)])
        apply_settings(tok, RECIPE_SETTINGS)
        inputs = docs + RECIPE_EXTRA
        out["slice_fast"] = [recipe_digest(e) for e in tok._tokenizer.encode_batch_fast(inputs)]
        out["slice_offsets"] = [offsets_digest(e) for e in tok.encode_batch(inputs)]
        out["slice_to_str"] = text_digest(tok.to_str())
        out["to_str"] = {c: text_digest(wheel.Tokenizer.from_str(config_json(c)).to_str())
                         for c in TO_STR_CONFIGS}
        vocab_txt = Tokenizer.from_str(config_json("bert"), device="cpu").model.save(d)[0]
        bert = recipes.BertWordPieceTokenizer(vocab_txt)
        apply_settings(bert, BERT_PAIR_SETTINGS)
        out["bert_pairs"] = [recipe_digest(e) for e in bert.encode_batch(bert_pairs(docs))]
        out["bert_to_str"] = text_digest(bert.to_str())
    trained = recipes.ByteLevelBPETokenizer()
    trained.train_from_iterator(train_lines(RECIPE_TRAIN["chars"]),
                                vocab_size=RECIPE_TRAIN["vocab_size"],
                                special_tokens=RECIPE_TRAIN["special_tokens"],
                                show_progress=False)
    out["trained_to_str"] = text_digest(trained.to_str())
    out["trained_fast"] = [ids_digest(e.ids) for e in trained._tokenizer.encode_batch_fast(docs)]
    return out


def write_recipes_digests():
    path = os.path.join(DATA, "recipes_digests.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(wheel_recipes_digests(), f, indent=0)
        f.write("\n")
    print("wrote", path)


def port_jax_api_digests():
    """Phase 18's trained tokenizer on the CPU: the port's own result, which
    the card must give again."""
    import tokenizers_tpu_torch as tt

    previous = tt.set_default_device("cpu")
    try:
        tok = jax_api_tokenizer(tt, train_lines(JAX_API_TRAIN["chars"]))
        return {"trained_to_str": text_digest(tok.to_str()),
                "trained_fast": [ids_digest(e.ids) for e in tok.encode_batch_fast(build_docs())],
                "tokens": jax_api_tokens(tok.model)}
    finally:
        tt.set_default_device(previous)


def write_jax_api_digests():
    path = os.path.join(DATA, "jax_api_digests.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(port_jax_api_digests(), f, indent=0, ensure_ascii=False)
        f.write("\n")
    print("wrote", path)


def main():
    alone = {"--recipes": write_recipes_digests, "--uprops": write_uprops,
             "--host-pipelines": write_host_pipelines_digests, "--graphemes": write_graphemes,
             "--charsmap": write_charsmap, "--unigram-round-trip": write_unigram_round_trip,
             "--jax-api": write_jax_api_digests}
    if any(a in alone for a in sys.argv[1:]):  # those files alone
        for a in sys.argv[1:]:
            if a in alone:
                alone[a]()
        return
    write_uprops()
    write_graphemes()
    write_charsmap()
    stage1, stage2 = class_tables()
    np.savez_compressed(TABLE_PATH, stage1=stage1, stage2=stage2)
    print("wrote", TABLE_PATH, os.path.getsize(TABLE_PATH), "bytes")
    for kind in ("whitespace", "whitespace_split"):
        s1, s2 = wordlevel_class_table(kind)
        np.savez_compressed(class_table_path(kind), s1=s1, s2=s2)
        print("wrote", class_table_path(kind), os.path.getsize(class_table_path(kind)), "bytes")
    train_char_configs("--retrain" in sys.argv)
    digests = {config: wheel_digests(config)
               for config in (*CONFIGS, *CHAR_CONFIGS, "spm_bf", *UNIGRAM_CONFIGS)}
    digests["sp_bpe_long"] = wheel_digests("sp_bpe", long_parts()["long"])
    digests["gpt2_long"] = wheel_digests("gpt2", sum(long_parts().values(), []))
    digests["bert_long"] = wheel_digests("bert", long_parts()["long"])
    digests["unigram_long"] = wheel_digests("unigram", long_parts()["long"])
    for config in (*CONFIGS, *CHAR_CONFIGS, *UNIGRAM_CONFIGS):
        digests[f"{config}_offsets"] = wheel_offsets_digests(config)
    for config in ("gpt2", "bert"):
        digests[f"{config}_long_offsets"] = wheel_offsets_digests(config, long_parts()["long"])
    for name, data, kw in (("unigram_train.json", wheel_unigram_train(), {"ensure_ascii": False}),
                           ("decode_digests.json", wheel_decode_digests(), {"indent": 0})):
        path = os.path.join(DATA, name)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, **kw)
            f.write("\n")
        print("wrote", path)
    path = os.path.join(DATA, "train_digests.json")
    with open(path, "w") as f:
        json.dump(wheel_train_digests(), f, indent=1)
        f.write("\n")
    print("wrote", path)
    for name, sha in digests.items():
        with open(digests_path(name), "w") as f:
            json.dump({"sha256": sha}, f, indent=0)
            f.write("\n")
        print("wrote", digests_path(name))
    write_recipes_digests()
    write_host_pipelines_digests()
    write_unigram_round_trip()
    write_jax_api_digests()


if __name__ == "__main__":
    main()
