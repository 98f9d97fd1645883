"""The documents `chip_smoke.py` encodes, and their committed digests.

`build_docs` cuts the corpus into 8 KB documents by the rule of
`bench.py`'s `build_docs`: repeat the text until it exceeds the target,
then take successive DOC_BYTES slices cut back to a UTF-8 character
boundary.  At the default 4 MiB target that is 512 documents: 492 pure
ASCII, which pack into two [256, 8192] chunks, and 20 with multi-byte
characters, which pack into one [32, 8192] chunk.

`long_parts` gives the documents of the long-document phase by part:
(a) `long_docs`, 32 KB corpus documents and three of about 100 KB, which
the engine splits into chunks of at most 32 KB ([64, 32768] ASCII chunks,
the cluster layout kernel's); (b) `dense_docs`, 12 KB documents of
distinct random words, whose unique words overflow the dedup buffer
([8, 16384], the full-width branch and the cluster merge kernel); (c) the
same at 16 KB, where two rounds at the full width leave more tokens than
the 5/8 width holds, so every row is flagged and the host encodes it.

`CHAR_CONFIGS` are the char-level phase's tokenizers, trained once from
the corpus with the wheel and committed in `data/` (`char_bpe.json`: the
`CharBPETokenizer` recipe; `sp_bpe.json`: `SentencePieceBPETokenizer`
with `fuse_unk`; `wordlevel.json`: WordLevel with NFD, StripAccents,
Lowercase and Whitespace), and `spm_bf_json` derives the Llama-2 SPM
shape from sp_bpe; their digests are `data/{char_bpe,sp_bpe,spm_bf,
wordlevel}_digests.json`, `data/sp_bpe_long_digests.json` (the long
documents (a)) and `data/{char_bpe,sp_bpe,wordlevel}_offsets_digests.json`.

`data/gpt2_digests.json`, `data/llama3_digests.json` and
`data/bert_digests.json` hold one SHA-256 per document of the ids the
`tokenizers` wheel gives (special tokens added) on the tokenizer of each
of `CONFIGS` (gpt2, llama3_128k, bert); `data/gpt2_long_digests.json`
those of the `long_parts()` documents, in order, on gpt2, and
`data/bert_long_digests.json` those of the long documents (a) on bert.
The `*_offsets_digests.json` files hold, per document, the SHA-256 of what
the wheel's `encode_batch` gives: ids, char offsets and word ids
(`offsets_digest`), for the 8 KB documents and, on gpt2 and bert, the
long documents (a).  `UNIGRAM_CONFIGS` are the fixtures of the Unigram
phase: `data/unigram_digests.json`, `unigram_long_digests.json` (the
long documents (a)), `unigram_offsets_digests.json`,
`unigram_bf_digests.json` and `unigram_bf_offsets_digests.json`
(`python -m tokenizers_tpu_torch.data.regen` writes them all;
`tests/test_torch_tables.py` re-derives them).  `data/train_digests.json`
holds, for each of `TRAIN_RUNS`, the SHA-256 of the merge list and of the
vocab that the wheel's BpeTrainer trains from the Whitespace words of the
corpus lines (`train_lines`, `merges_digest`, `vocab_digest`), and their
sizes; `regen` writes it too.  `recipe_json` gives a frozen recipe's
tokenizer as it is before training.  `data/unigram_train.json` holds the
wheel's UnigramTrainer result at `UNIGRAM_TRAIN` on the `unigram` recipe
(`load_unigram_train`), and `data/decode_digests.json`, per tokenizer of
`DECODE_CONFIGS`, the SHA-256 of each 8 KB document's text as the wheel's
`decode_batch` gives it back from the wheel's ids (`text_digest`), with
and without `skip_special_tokens`, and for `STREAM_CONFIGS` the digest of
each of the first `STREAM_DOCS` documents' `DecodeStream` steps
(`stream_digest`).

`host_pipelines` builds the six pipelines of `chip_smoke.py` phase 16
from the fixtures and the frozen files: four that no engine takes and the
general host pipeline runs (`HOST_PIPELINES`, on the first `HOST_DOCS`
8 KB documents) and two that are new to the byte-level engine
(`ENGINE_PIPELINES`, on all 512); and phase 17's `t5_shape` (a
`Precompiled` normalizer, on the host, the first `HOST_DOCS` documents).
`host_pipeline_docs` gives each its
documents, and `data/host_pipelines_digests.json` the wheel's ids and
offsets digests of them (`load_host_pipelines_digests`).

`jax_api_tokenizer` builds and trains phase 18's tokenizer through the
JAX package's public names alone, on the port imported as `tt`;
`load_jax_api_digests` gives what that phase gave on the CPU.

`first_ascii_chunk` and `unique_state` give the merge loop's first state
at the gpt2 path's unique buffer, where `chip_smoke.py` and
`tools/b1_phases.py` hold and time B1; `llama3_unique_state` that of the
llama-3 path (whole-word bypass applied), where they hold and time B4;
`full_width_state` the first state
of the full-width branch, and `full_width_states` the two such states at
which the tools and `chip_smoke.py` time the wide B1; `offsets_states`
the offsets path's [256, 8192] and [256, 5120] states, where they time
it too; `corpus_chunk` the
corpus chunks at which they time the wide B3.  `adversarial_case` builds the
edge-case merge layouts on which `chip_smoke.py` and the tests hold the
merge kernels against their plain versions; `adversarial_layout_case` the
edge-case byte rows for the layout kernel.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from typing import Dict, List, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fixtures", "corpus.txt")
CONFIGS = {  # config -> its tokenizer.json
    "gpt2": os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json"),
    "llama3": os.path.join(REPO, "tests", "fixtures", "llama3_128k", "tokenizer.json"),
    "bert": os.path.join(REPO, "tests", "fixtures", "bert", "tokenizer.json"),
}
GPT2_JSON = CONFIGS["gpt2"]
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the char-level phase's tokenizers, trained once from the corpus with the
# `tokenizers` wheel and committed (`data/regen.py`); spm_bf is derived
# from sp_bpe at run time (`spm_bf_json`)
CHAR_CONFIGS = {
    "char_bpe": os.path.join(DATA, "char_bpe.json"),
    "sp_bpe": os.path.join(DATA, "sp_bpe.json"),
    "wordlevel": os.path.join(DATA, "wordlevel.json"),
}
# the Unigram phase's tokenizers: the repo's fixtures (xlnet style, the
# reference's `unigram_benchmark.rs` config; and with byte fallback)
UNIGRAM_CONFIGS = {
    "unigram": os.path.join(REPO, "tests", "fixtures", "unigram", "tokenizer.json"),
    "unigram_bf": os.path.join(REPO, "tests", "fixtures", "unigram_bf", "tokenizer.json"),
}
DOC_BYTES = 8 * 1024
TARGET_BYTES = 4 << 20
LONG_DOC_BYTES = 32 * 1024
SPLIT_DOC_BYTES = 100_000  # > packing.MAX_L // 2: split at safe seams
DENSE_DOCS = 8
DENSE_BYTES = 12 * 1024  # (b): the card finishes every row
DENSE_OVERFLOW_BYTES = 16 * 1024  # (c): every row overflows the 5/8 width
DENSE_SEED = 0
# the training phase's runs held against the wheel's BpeTrainer over the
# Whitespace words of the corpus lines (`data/train_digests.json`):
# name -> (characters of the corpus, None for all; vocab size)
TRAIN_RUNS = {"bench_512": (1 << 20, 512), "corpus_16000": (None, 16000)}
# the Unigram training phase: the `unigram` fixture's pipeline retrained by
# UnigramTrainer(vocab_size, special_tokens=["<unk>"], unk_token="<unk>")
# on the lines of the corpus's first `chars` characters (`bench.py`'s slice)
UNIGRAM_TRAIN = {"chars": 1 << 20, "vocab_size": 8000}
# the decode phase: the tokenizers whose 8 KB document ids it decodes
# (`decode_batch`, both `skip_special_tokens`), and those whose first
# STREAM_DOCS documents it decodes through `decode_stream`
DECODE_CONFIGS = ("gpt2", "llama3", "bert", "unigram", "unigram_bf", "char_bpe", "sp_bpe",
                  "spm_bf", "wordlevel")
STREAM_CONFIGS = ("gpt2", "unigram_bf")
STREAM_DOCS = 32
# the recipes phase (`chip_smoke.py` phase 15, `data/recipes_digests.json`):
# a non-special added token (lstrip, rstrip) that no 8 KB document holds,
# and the extra inputs that hold it or `<|endoftext|>` (the host path)
RECIPE_TOKEN = "<|recipe token|>"
RECIPE_EXTRA = ["a " + RECIPE_TOKEN + " b", RECIPE_TOKEN,
                "x  " + RECIPE_TOKEN + "  y<|endoftext|>z", "tail<|endoftext|>"]
RECIPE_SETTINGS = {"truncation": dict(max_length=1024, stride=128),
                   "padding": dict(pad_to_multiple_of=8)}
BERT_PAIRS = 128  # pairs of the documents' first BERT_PAIR_CHARS chars
BERT_PAIR_CHARS = 2048
BERT_PAIR_SETTINGS = {"truncation": dict(max_length=512, strategy="longest_first"),
                      "padding": dict(length=512)}
RECIPE_TRAIN = {"chars": 1 << 20, "vocab_size": 8000, "special_tokens": ["<|endoftext|>"]}
# the tokenizers whose `to_str` phase 15 (b) round-trips on the card
TO_STR_CONFIGS = ("gpt2", "llama3", "bert", "unigram", "unigram_bf", "char_bpe", "sp_bpe",
                  "spm_bf", "wordlevel")

# phase 16: the general host pipeline's cells (no engine takes them) and
# the byte-level engine's two new pipelines
HOST_PIPELINES = ("gpt2_lower", "qwen2_shape", "char_bpe_punct", "wordlevel_scripts")
T5_SHAPE = "t5_shape"  # phase 17 (a): the Precompiled normalizer, on the host
ENGINE_PIPELINES = ("gpt2_ignore_merges", "llama3_prefix")
HOST_DOCS = 16
# phase 18, the JAX package's public API (`jax_api_tokenizer`): a byte-level
# BPE trained at `vocab_size` on the lines of the corpus's first `chars`
# characters; `model.tokenize` of JAX_API_WORDS; `decode_stream` of the first
# STREAM_DOCS documents (`data/jax_api_digests.json`: the phase on the CPU)
JAX_API_TRAIN = {"chars": 1 << 18, "vocab_size": 8000, "special_token": "<|endoftext|>"}
JAX_API_WORDS = ("Hello", "Ġworld", "Ġtokenization", "Ġ12345", "ĠcafÃ©", "ĠÐŁÑĢÐ¸Ð²ÐµÑĤ",
                 "ĊĊ", "Ġ'll've")
# Qwen2's published split: the llama-3 pattern with \p{N} for \p{N}{1,3}
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


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


def long_docs() -> List[str]:
    """32 KB corpus documents (`build_docs` at 4 MB) and three documents of
    about 100 KB, which `engine_base` splits into chunks of at most 32 KB."""
    return (build_docs(TARGET_BYTES, LONG_DOC_BYTES)
            + build_docs(3 * SPLIT_DOC_BYTES, SPLIT_DOC_BYTES))


def dense_docs(n: int = DENSE_DOCS, nbytes: int = DENSE_BYTES,
               seed: int = DENSE_SEED) -> List[str]:
    """n documents of at most nbytes: random words of 4-8 lowercase
    letters, as ids in logs (letters: the GPT-2 pattern splits letters
    from digits, so each word stays one pre-token), separated by spaces.
    Almost every word is distinct, so a chunk of them overflows its dedup
    buffer and takes the full-width branch."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        lens = rng.integers(4, 9, nbytes // 4)
        keep = int(np.searchsorted(np.cumsum(lens + 1), nbytes + 1))  # words that fit
        letters = rng.integers(97, 123, int(lens[:keep].sum()), dtype=np.uint8)
        cuts = np.cumsum(lens[:keep])[:-1]
        docs.append(" ".join(w.tobytes().decode() for w in np.split(letters, cuts)))
    return docs


def long_parts() -> Dict[str, List[str]]:
    """The long-document phase's documents by part, in the order of
    `data/gpt2_long_digests.json`."""
    return {"long": long_docs(), "dense": dense_docs(),
            "dense_16k": dense_docs(nbytes=DENSE_OVERFLOW_BYTES)}


def spm_bf_json() -> str:
    """The Llama-2 SPM shape from `data/sp_bpe.json`: the 256 `<0xXX>`
    tokens appended to the vocab, the normalizer Sequence[Prepend("▁"),
    Replace(" ", "▁")], no pre-tokenizer, `byte_fallback` and `fuse_unk`,
    and the decoder Sequence[Replace("▁", " "), ByteFallback, Fuse,
    Strip(" ", 1, 0)]."""
    with open(CHAR_CONFIGS["sp_bpe"], encoding="utf-8") as f:
        d = json.load(f)
    vocab = d["model"]["vocab"]
    base = max(vocab.values()) + 1
    for bb in range(256):
        vocab.setdefault(f"<0x{bb:02X}>", base + bb)
    d["model"].update(byte_fallback=True, fuse_unk=True)
    d["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"},
        {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
    d["pre_tokenizer"] = None
    d["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    return json.dumps(d, ensure_ascii=False)


def config_json(config: str) -> str:
    """The tokenizer.json text of a config of CONFIGS, CHAR_CONFIGS,
    UNIGRAM_CONFIGS or "spm_bf"."""
    if config == "spm_bf":
        return spm_bf_json()
    with open({**CONFIGS, **CHAR_CONFIGS, **UNIGRAM_CONFIGS}[config], encoding="utf-8") as f:
        return f.read()


def host_pipelines() -> Dict[str, str]:
    """The tokenizer.json text of each phase-16 pipeline:

    * gpt2_lower: the gpt2 fixture behind a Lowercase normalizer (the
      shape of `ByteLevelBPETokenizer(lowercase=True)`);
    * qwen2_shape: the llama3_128k fixture's model and ByteLevel behind
      NFC and Split(Regex(QWEN2_PATTERN), Isolated);
    * char_bpe_punct: `data/char_bpe.json` under Sequence[WhitespaceSplit,
      Punctuation, Digits(individual_digits=True)];
    * wordlevel_scripts: `data/wordlevel.json`'s normalizer and model under
      Sequence[UnicodeScripts, Whitespace];
    * gpt2_ignore_merges: the gpt2 fixture with `ignore_merges`;
    * llama3_prefix: llama3_128k, its ByteLevel adding a prefix space;
    * t5_shape (phase 17): the unigram fixture's model and Metaspace behind
      Sequence[Precompiled(`data/charsmap_nfkc.bin`), Replace(" {2,}",
      " ")], the pipeline shape of T5's published tokenizer.json."""
    def load(config):
        return json.loads(config_json(config))

    out = {}
    d = load("gpt2")
    d["normalizer"] = {"type": "Lowercase"}
    out["gpt2_lower"] = d
    d = load("llama3")
    d["normalizer"] = {"type": "NFC"}
    d["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": QWEN2_PATTERN}
    out["qwen2_shape"] = d
    d = load("char_bpe")
    d["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"}, {"type": "Punctuation", "behavior": "Isolated"},
        {"type": "Digits", "individual_digits": True}]}
    out["char_bpe_punct"] = d
    d = load("wordlevel")
    d["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "UnicodeScripts"}, {"type": "Whitespace"}]}
    out["wordlevel_scripts"] = d
    d = load("gpt2")
    d["model"]["ignore_merges"] = True
    out["gpt2_ignore_merges"] = d
    d = load("llama3")
    d["pre_tokenizer"]["pretokenizers"][1]["add_prefix_space"] = True
    out["llama3_prefix"] = d
    d = load("unigram")
    with open(os.path.join(DATA, "charsmap_nfkc.bin"), "rb") as f:
        charsmap = base64.b64encode(f.read()).decode("ascii")
    d["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": charsmap},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    out[T5_SHAPE] = d
    return {k: json.dumps(v, ensure_ascii=False) for k, v in out.items()}


def host_pipeline_docs(name: str) -> List[str]:
    """The documents phase 16 encodes with pipeline `name`."""
    docs = build_docs()
    return docs if name in ENGINE_PIPELINES else docs[:HOST_DOCS]


def load_host_pipelines_digests() -> Dict[str, Dict[str, List[str]]]:
    with open(os.path.join(DATA, "host_pipelines_digests.json"), encoding="utf-8") as f:
        return json.load(f)


def train_lines(nchars=None) -> List[str]:
    """The lines of the corpus (of its first `nchars` characters), as
    `bench.py`'s `train` config splits them."""
    with open(CORPUS, encoding="utf-8") as f:
        return f.read()[:nchars].splitlines()


def merges_digest(merges) -> str:
    """SHA-256 of a merge list [(a, b), ...] as a JSON list of pairs."""
    return hashlib.sha256(json.dumps([list(m) for m in merges], ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


def vocab_digest(vocab: Dict[str, int]) -> str:
    """SHA-256 of a vocab as a JSON list of [token, id] in id order."""
    return hashlib.sha256(json.dumps(sorted(vocab.items(), key=lambda kv: kv[1]),
                                     ensure_ascii=False).encode("utf-8")).hexdigest()


def load_train_digests() -> Dict[str, Dict[str, object]]:
    with open(os.path.join(DATA, "train_digests.json")) as f:
        return json.load(f)


def recipe_json(config: str) -> str:
    """A CHAR_CONFIGS or UNIGRAM_CONFIGS tokenizer as its recipe builds it
    before training: the same pipeline with no added tokens and an empty
    vocab, for Unigram the reference's default model (`<unk>` alone, unk
    id 0) (the recipe adds its special tokens after training, so they
    never split the training text).  char_bpe and sp_bpe come from the
    port's recipes (`CharBPETokenizer()`,
    `SentencePieceBPETokenizer(fuse_unk=True)`), the others from the
    frozen file cleared."""
    if config == "char_bpe":
        from .implementations import CharBPETokenizer

        return CharBPETokenizer(device="cpu").to_str()
    if config == "sp_bpe":
        from .implementations import SentencePieceBPETokenizer

        return SentencePieceBPETokenizer(fuse_unk=True, device="cpu").to_str()
    d = json.loads(config_json(config))
    d["added_tokens"] = []
    if d["model"]["type"] == "Unigram":
        d["model"].update(vocab=[["<unk>", 0.0]], unk_id=0)
    else:
        d["model"]["vocab"] = {}
    if "merges" in d["model"]:
        d["model"]["merges"] = []
    return json.dumps(d, ensure_ascii=False)


def load_unigram_train() -> Dict[str, object]:
    """The wheel's Unigram training at UNIGRAM_TRAIN (`data/
    unigram_train.json`: its settings and the trained [piece, score]
    list)."""
    with open(os.path.join(DATA, "unigram_train.json"), encoding="utf-8") as f:
        return json.load(f)


def load_unigram_round_trip_digests() -> Dict[str, List[str]]:
    """The wheel's ids digests of the 8 KB documents with the model of
    `load_unigram_train`, in memory ("trained") and after its own `to_str`
    round trip ("round_trip") (`data/unigram_round_trip_digests.json`)."""
    with open(os.path.join(DATA, "unigram_round_trip_digests.json")) as f:
        return json.load(f)


def text_digest(s: str) -> str:
    return hashlib.sha256(s.encode("utf-8")).hexdigest()


def stream_digest(pieces) -> str:
    """SHA-256 of what a DecodeStream's steps gave (None as null), as JSON."""
    return hashlib.sha256(json.dumps(list(pieces), ensure_ascii=False).encode("utf-8")).hexdigest()


def load_decode_digests() -> Dict[str, object]:
    with open(os.path.join(DATA, "decode_digests.json")) as f:
        return json.load(f)


def ids_digest(ids: Sequence[int]) -> str:
    return hashlib.sha256(np.asarray(ids, dtype="<i4").tobytes()).hexdigest()


def offsets_digest(enc) -> str:
    """SHA-256 of an encoding's ids, char offsets and word ids (None as
    -1), as little-endian int32 in that order."""
    words = [-1 if w is None else w for w in enc.word_ids]
    return hashlib.sha256(np.asarray(
        list(enc.ids) + [x for o in enc.offsets for x in o] + words, dtype="<i4").tobytes()
    ).hexdigest()


def recipe_digest(enc) -> str:
    """SHA-256 of an encoding's ids, type ids and attention mask, then each
    overflowing window's ids (-1 between windows), as little-endian
    int32."""
    flat = list(enc.ids) + list(enc.type_ids) + list(enc.attention_mask)
    for o in enc.overflowing:
        flat += [-1] + list(o.ids)
    return hashlib.sha256(np.asarray(flat, dtype="<i4").tobytes()).hexdigest()


def bert_pairs(docs: Sequence[str]) -> List[tuple]:
    """BERT_PAIRS pairs of consecutive documents' first BERT_PAIR_CHARS
    chars."""
    return [(docs[2 * i][:BERT_PAIR_CHARS], docs[2 * i + 1][:BERT_PAIR_CHARS])
            for i in range(BERT_PAIRS)]


def apply_settings(tok, settings) -> None:
    tok.enable_truncation(**settings["truncation"])
    tok.enable_padding(**settings["padding"])


def load_recipes_digests() -> Dict[str, object]:
    with open(os.path.join(DATA, "recipes_digests.json"), encoding="utf-8") as f:
        return json.load(f)


def jax_api_tokenizer(tt, lines):
    """Phase 18's trained tokenizer, built and trained only through the JAX
    package's public names on `tt` (the port, imported as the JAX package
    is): BPE without an unk token, ByteLevel pre-tokenizer (no prefix
    space) and decoder, BpeTrainer with the byte alphabet and the special
    token.  On the default device: the card, or the CPU after
    `tt.set_default_device("cpu")`."""
    tok = tt.Tokenizer(tt.models.BPE(unk_token=None))
    tok.pre_tokenizer = tt.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tt.decoders.ByteLevel()
    trainer = tt.trainers.BpeTrainer(
        vocab_size=JAX_API_TRAIN["vocab_size"], show_progress=False,
        initial_alphabet=tt.pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=[tt.AddedToken(JAX_API_TRAIN["special_token"], special=True)])
    tok.train_from_iterator(lines, trainer)
    return tok


def jax_api_tokens(model) -> List[list]:
    """(id, value, offsets) of each Token `model.tokenize` gives for each of
    JAX_API_WORDS."""
    return [[[t.id, t.value, list(t.offsets)] for t in model.tokenize(w)] for w in JAX_API_WORDS]


def load_jax_api_digests() -> Dict[str, object]:
    """Phase 18 run on the CPU (`data/regen.py --jax-api`): the trained
    tokenizer's `to_str` digest, its ids digests of the 8 KB documents,
    and `jax_api_tokens` of its model."""
    with open(os.path.join(DATA, "jax_api_digests.json"), encoding="utf-8") as f:
        return json.load(f)


def digests_path(config: str = "gpt2") -> str:
    return os.path.join(DATA, f"{config}_digests.json")


def load_digests(config: str = "gpt2") -> List[str]:
    with open(digests_path(config)) as f:
        return json.load(f)["sha256"]


def first_ascii_chunk(eng, prepared, shape=(256, 8192), device="cuda"):
    """The first ASCII chunk of `shape` of the packed documents `prepared`:
    (bytes int32, lengths, in-bounds mask)."""
    import torch

    from .ops.packing import pack_batch

    buf, lens, _ = next(c for c in pack_batch(prepared)
                        if c[0].shape == tuple(shape) and eng._is_ascii(c[0]))
    b = torch.from_numpy(buf).to(device).to(torch.int32)
    n = torch.from_numpy(lens).to(device)
    inb = torch.arange(b.shape[1], device=b.device)[None, :] < n[:, None]
    return b, n, inb


def corpus_chunk(eng, shape, device="cuda"):
    """The first ASCII chunk of `shape` = (B, L) of the corpus cut into
    documents of L bytes (`build_docs`): (bytes int32, lengths, in-bounds
    mask)."""
    docs = build_docs(doc_bytes=shape[1])
    return first_ascii_chunk(eng, [eng._prepare(d) for d in docs], shape, device)


def full_width_states(eng, device="cuda"):
    """{(R, C): B1's args (ids, own_l, own_r, wid, h0, h1, nid, rows0,
    rows1, seed)} at two full-width states: the first 8 rows of the 8 KB
    documents' first [256, 8192] ASCII chunk, and the [32, 16384] chunk of
    32 dense documents.  Boundaries and keys come from the kernels of the
    package this module is loaded in."""
    from .ops import layout_kernels as lk
    from .ops import merge_kernels as mk

    T = eng.tables
    tabs = (T["merge_rows0"], T["merge_rows1"], T["seed"])
    states = {}
    for docs, shape, rows in ((build_docs(), (256, 8192), 8),
                              (dense_docs(32), (32, 16384), 32)):
        b, n, inb = first_ascii_chunk(eng, [eng._prepare(d) for d in docs], shape, device)
        b, n, inb = b[:rows], n[:rows], inb[:rows]
        ids, own_l, own_r, wid = full_width_state(eng, b, inb, lk.layout_fused(b, n)[0])
        states[(rows, shape[1])] = (ids, own_l, own_r, wid,
                                    *mk.keys(ids, tabs[0], tabs[2]), *tabs)
    return states


def offsets_states(eng, device="cuda"):
    """{(R, C): B1's args (ids, own_l, own_r, wid, h0, h1, nid, rows0,
    rows1, seed)} at the offsets path's two cluster-B1 widths for the first
    [256, 8192] ASCII chunk of the 8 KB documents (`build_docs`): its
    full-width state, and the state two rounds on, compacted to the 5/8
    width 5120 (`bpe_merge2.run_merge_phases`).  Rounds, boundaries and
    keys come from the kernels of the package this module is loaded in."""
    from .ops import layout_kernels as lk
    from .ops import merge_kernels as mk
    from .ops.bpe_merge2 import compact

    T = eng.tables
    tabs = (T["merge_rows0"], T["merge_rows1"], T["seed"])
    b, n, inb = first_ascii_chunk(eng, [eng._prepare(d) for d in build_docs()], device=device)
    ids, own_l, own_r, wid = full_width_state(eng, b, inb, lk.layout_fused(b, n)[0])
    args = (ids, own_l, own_r, wid, *mk.keys(ids, tabs[0], tabs[2]), *tabs)
    states = {(256, 8192): args}
    for _ in range(2):
        out = mk.merge_round_fused(*args)
        args = (*out[:3], wid, *out[4:7], *tabs)
    ids, wid, _bad, (own_l, own_r) = compact(args[0], wid, 5120, args[1:3])
    states[(256, 5120)] = (ids, own_l, own_r, wid, *mk.keys(ids, tabs[0], tabs[2]), *tabs)
    return states


def full_width_state(eng, b, inb, bnd):
    """The full-width branch's first state (ids, own_l, own_r, wid) of the
    chunk b from its boundaries (`bpe_encode.encode_core`)."""
    import torch

    from .ops.bpe_merge2 import init_own

    T = eng.tables
    ids = torch.where(inb, T["byte2id"][b.to(torch.int64)], -1)
    wid = torch.where(inb, torch.cumsum(bnd.int(), 1, dtype=torch.int32) - 1, -1)
    own_l, own_r = init_own(ids, T["merge_mclr"])
    return ids, own_l, own_r, wid


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


def llama3_unique_state(eng, device="cuda"):
    """The merge loop's first state (ids, own_l, own_r, wid) at the llama-3
    path's unique buffer of the first [256, 8192] ASCII chunk of the 8 KB
    documents (`build_docs`), the whole-word bypass applied; eng is a
    llama3 engine."""
    import torch

    from .ops.bpe_dedup import (
        H1_MULT, H2_MULT, buffer_geometry, dedup_layout, unique_buffer, whole_word_ids,
        word_hash_heads,
    )
    from .ops.bpe_merge2 import init_own
    from .ops.layout_kernels import next_boundary
    from .ops.llama3_presplit import llama3_boundaries

    T = eng.tables
    b, n, inb = first_ascii_chunk(eng, [eng._prepare(d) for d in build_docs()], device=device)
    bnd, _ = llama3_boundaries(b, inb, T["cls_table"], ascii_only=True)
    geom = buffer_geometry(b.numel())
    fits, ops = dedup_layout(b, bnd, inb, n, next_boundary(bnd), T["seed"], geom)
    if not fits:
        raise SystemExit("the llama3 corpus chunk does not fit its dedup buffer")
    b_u, uhead, inb_u, wid, wend_f, upos_f = unique_buffer(ops, b, geom)
    ids = torch.where(inb_u, T["byte2id"][b_u.to(torch.int64)], -1)
    ids = whole_word_ids(
        ids, uhead, inb_u, word_hash_heads(b_u, uhead, inb_u, H1_MULT),
        word_hash_heads(b_u, uhead, inb_u, H2_MULT),
        torch.where(uhead, wend_f - upos_f, 0), T["ww_rows0"], T["ww_rows1"],
        T["ww_seed"],
    )
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


CONTRACTIONS = (b"'s", b"'t", b"'re", b"'ve", b"'m", b"'ll", b"'d",
                b"'S", b"'T", b"'RE", b"'VE", b"'M", b"'LL", b"'D")
WHITESPACE = np.frombuffer(b" \t\r\n\x0b\x0c", np.uint8)
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)
DENSE = np.frombuffer(b"'''''     0123456789abcdefxyzRSTVLMD.,\n\t", np.uint8)


def adversarial_layout_case(seed: int, B: int, L: int, k: int = 16, reach: int = 512):
    """ASCII rows for the layout kernel (`csrc/layout.cu`), built to hit the
    edges of a kernel whose threads own k contiguous positions, 32 * k to a
    warp, the tiled kernel's 1024-wide tiles, and the 2^9 reach of the hash
    delivery.  Row r holds text of kind r % 6:

    0. contractions ('s 't 're 've 'm 'll 'd and their upper-case
       look-alikes, after letters, digits, whitespace or punctuation) whose
       apostrophe falls 3 before to 1 after multiples of k, 32 * k and 1024;
    1. whitespace runs (spaces and \\t \\r \\n \\v \\f) ending just before, on
       and after those edges, each followed by a word or by more whitespace;
    2. words of reach - 1, reach, reach + 1 and more than L / 2 letters
       (those that fit), between short words and contractions;
    3. every whitespace byte, with words, digits and contractions;
    4. random printable ASCII dense in apostrophes, spaces and digits, the
       row's last byte an apostrophe;
    5. random printable ASCII;

    and is cut to the length of case r % 5: 0, 1, L - 1, L, random.  Bytes
    past a row's length are 0.  Returns (bytes int32[B, L], lengths
    int32[B]), numpy."""
    rng = np.random.default_rng(seed)
    before = b"aZ9 \t\n.-'"

    def word(n):
        return bytes(rng.choice(LETTERS, size=n))

    def blanks(n):
        return bytes(rng.choice(WHITESPACE, size=n))

    edges = sorted({m for step in (k, 32 * k, 1024) for m in range(step, L, step)})
    buf = np.zeros((B, L), np.int32)
    lens = np.zeros((B,), np.int32)
    for r in range(B):
        kind = r % 6
        row = bytearray(rng.integers(32, 127, size=L, dtype=np.uint8).tobytes())
        if kind == 0:
            for m in edges:
                if rng.random() < 0.4:
                    at = m + int(rng.integers(-3, 2))  # the apostrophe's position
                    piece = (bytes([before[int(rng.integers(len(before)))]])
                             + CONTRACTIONS[int(rng.integers(len(CONTRACTIONS)))]
                             + word(int(rng.integers(0, 3))))
                    if at >= 1 and at - 1 + len(piece) <= L:
                        row[at - 1:at - 1 + len(piece)] = piece
        elif kind == 1:
            for m in edges:
                if rng.random() < 0.6:
                    end = m + int(rng.integers(-1, 2))  # one past the run's last byte
                    n = int(rng.integers(1, 9))
                    piece = blanks(n) + (word(2) if rng.random() < 0.7 else b"  ")
                    if end - n >= 0 and end - n + len(piece) <= L:
                        row[end - n:end - n + len(piece)] = piece
        elif kind == 2:
            col = 0
            sizes = [reach - 1, reach, reach + 1, L // 2 + 1 + int(rng.integers(8))]
            rng.shuffle(sizes)
            for n in sizes:
                piece = b" " + word(n) + b" x, 's"
                if col + len(piece) <= L:
                    row[col:col + len(piece)] = piece
                    col += len(piece)
        elif kind == 3:
            col = 0
            while col < L:
                pick = int(rng.integers(4))
                piece = (blanks(int(rng.integers(1, 5))) if pick == 0
                         else word(int(rng.integers(1, 6))) if pick == 1
                         else str(int(rng.integers(10 ** 6))).encode() if pick == 2
                         else CONTRACTIONS[int(rng.integers(len(CONTRACTIONS)))])
                piece = piece[:L - col]
                row[col:col + len(piece)] = piece
                col += len(piece)
        elif kind == 4:
            row = bytearray(rng.choice(DENSE, size=L).tobytes())
        n = (0, 1, L - 1, L, int(rng.integers(2, L)))[r % 5]
        if kind == 4 and n >= 1:
            row[n - 1] = ord("'")
        buf[r, :n] = np.frombuffer(bytes(row[:n]), np.uint8)
        lens[r] = n
    return buf, lens
