"""Every pipeline the JAX package loads, in the port, on the CPU:

* **encodings**: on phase 16's host pipelines and on a pipeline for every
  case of the conformance files (each pre-tokenizer before the frozen
  char-level BPE model; each normalizer before it with WhitespaceSplit),
  `encode_batch`'s ids, tokens, char offsets and word ids equal the
  wheel's and JAX's host path's, byte offsets JAX's, with pairs and
  pre-tokenized input;
* **dropout**: at 0 and 1 equal to the wheel and JAX, at 0.3 equal to JAX
  under `random.seed(s)` when the port's model draws from
  `random.Random(s)`;
* **fast path**: on the fixtures and frozen tokenizers the general
  pipeline gives the fast host path's encodings, encoding for encoding;
* **training**: the words a Punctuation/Digits pipeline feeds a trainer
  are JAX's, and the trained vocab and merges JAX's and the wheel's;
* **to_str** of every new component equals the wheel's;
* the two pipelines new to the byte-level engine (gpt2 with
  `ignore_merges`, llama3 with a prefix space) equal the wheel through
  the plain kernel versions, and JAX's engine departs from the wheel on
  the second (the port follows the wheel).

JAX is run on its host objects (its host path `_encode`), so no JAX
device program is compiled.  The routing of these pipelines is held
against JAX's in `test_torch_routing.py`.
"""

import json
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tokenizers as hf  # noqa: E402
import tokenizers.implementations as wheel_recipes  # noqa: E402

import tokenizers_tpu as tt  # noqa: E402
from tokenizers_tpu.serialization import normalizer_to_dict, pre_tokenizer_to_dict  # noqa: E402
from tokenizers_tpu_torch import Tokenizer  # noqa: E402
from tokenizers_tpu_torch import implementations as port_recipes  # noqa: E402
from tokenizers_tpu_torch.smoke_data import (  # noqa: E402
    ENGINE_PIPELINES, HOST_PIPELINES, build_docs, config_json, host_pipelines,
)
from corpus import SHORT_STRINGS  # noqa: E402
from test_conformance_normalizers import pairs as normalizer_pairs  # noqa: E402
from test_conformance_pretokenizers import pairs as pre_tokenizer_pairs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("gpt2", "llama3", "bert", "unigram", "unigram_bf", "char_bpe", "sp_bpe", "spm_bf",
           "wordlevel")
TEXTS = SHORT_STRINGS + ["x²y ½z a‌b ‍q ＡＢＣ１２３", "Don'ſ 1234567\r\n\r\n  x"]
_DOCS = None


def _docs():
    global _DOCS
    if _DOCS is None:
        _DOCS = build_docs()
    return _DOCS


def _blob(name: str) -> str:
    if name == "llama3_small":
        with open(os.path.join(REPO, "tests", "fixtures", "llama3", "tokenizer.json"),
                  encoding="utf-8") as f:
            return f.read()
    return host_pipelines()[name] if name in HOST_PIPELINES + ENGINE_PIPELINES \
        else config_json(name)


def _fields(e):
    return (e.ids, e.tokens, [tuple(o) for o in e.offsets], list(e.word_ids), list(e.type_ids))


def _same_as_references(blob: str, texts=TEXTS, pairs=True, batch=True) -> None:
    """encode_batch (with `batch`, else the host path alone) equals the
    wheel's and JAX's host path's; byte offsets JAX's; pairs and
    pre-tokenized input the wheel's."""
    ours, jax, wheel = (Tokenizer.from_str(blob, device="cpu"), tt.Tokenizer.from_str(blob),
                        hf.Tokenizer.from_str(blob))
    got = ours.encode_batch(texts) if batch else [ours._encode(t, None, True, "char")
                                                  for t in texts]
    for g, w, t in zip(got, wheel.encode_batch(texts), texts):
        assert _fields(g) == _fields(w) == _fields(jax._encode(t, None, True, "char")), t
    if batch:
        assert [e.ids for e in ours.encode_batch_fast(texts)] == [e.ids for e in got]
    byte = ours.encode_batch_byte_offsets(texts) if batch else [
        ours._encode(t, None, True, "byte") for t in texts]
    for t, g in zip(texts, byte):
        assert _fields(g) == _fields(jax._encode(t, None, True, "byte")), t
    if pairs:
        for a, b in ((texts[4], texts[5]), ("", texts[-1])):
            assert _fields(ours.encode(a, b)) == _fields(wheel.encode(a, b)), (a, b)
        words = ["Hello", "wörld!", "", "x²y 12"]
        assert _fields(ours.encode(words, is_pretokenized=True)) == \
            _fields(wheel.encode(words, is_pretokenized=True))


@pytest.mark.parametrize("name", HOST_PIPELINES)
def test_host_pipeline_equals_references(name):
    _same_as_references(_blob(name), TEXTS[:24] + [d[:1500] for d in _docs()[:2]])


_SMALL = None


def _char_bpe_with(**components) -> str:
    """`data/char_bpe.json` cut to its first 2,500 ids (the alphabet and
    the merges among them), with `components` in place."""
    global _SMALL
    if _SMALL is None:
        d = json.loads(config_json("char_bpe"))
        vocab = {t: i for t, i in d["model"]["vocab"].items() if i < 2500}
        d["model"]["vocab"] = vocab
        d["model"]["merges"] = [m for m in d["model"]["merges"]
                                if m[0] in vocab and m[1] in vocab and m[0] + m[1] in vocab]
        _SMALL = d
    d = dict(_SMALL, **components)
    return json.dumps(d, ensure_ascii=False)


@pytest.mark.parametrize("name,ref,mine", list(pre_tokenizer_pairs()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_conformance_pre_tokenizer_pipeline(name, ref, mine):
    _same_as_references(_char_bpe_with(normalizer=None, pre_tokenizer=pre_tokenizer_to_dict(mine)),
                        pairs=name in ("punct", "digits", "scripts", "sequence"), batch=False)


@pytest.mark.parametrize("name,ref,mine", list(normalizer_pairs()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_conformance_normalizer_pipeline(name, ref, mine):
    _same_as_references(_char_bpe_with(normalizer=normalizer_to_dict(mine),
                                       pre_tokenizer={"type": "WhitespaceSplit"}),
                        pairs=name in ("bytelevel", "replace_re"), batch=False)


@pytest.mark.parametrize("config,dropout", [("gpt2", 0.0), ("gpt2", 1.0), ("char_bpe", 0.0),
                                            ("char_bpe", 1.0), ("gpt2", 0.3),
                                            ("char_bpe", 0.3)])
def test_dropout(config, dropout):
    d = json.loads(config_json(config))
    d["model"]["dropout"] = dropout
    blob = json.dumps(d, ensure_ascii=False)
    texts = TEXTS[:20] + [_docs()[0][:600]]
    ours, jax = Tokenizer.from_str(blob, device="cpu"), tt.Tokenizer.from_str(blob)
    if dropout in (0.0, 1.0):
        wheel = hf.Tokenizer.from_str(blob)
        for t in texts:
            assert _fields(ours.encode(t)) == _fields(wheel.encode(t)) == \
                _fields(jax._encode(t, None, True, "char")), t
        return
    for seed, t in enumerate(texts):
        ours.model.rng = random.Random(seed)
        random.seed(seed)
        assert _fields(ours.encode(t)) == _fields(jax._encode(t, None, True, "char")), t


@pytest.mark.parametrize("config", CONFIGS)
def test_general_pipeline_equals_fast_path(config):
    tok = Tokenizer.from_str(config_json(config), device="cpu")
    tok._check()
    assert tok._fast, config
    added = [t for t in ("<|endoftext|>", "[SEP]", "<unk>", "[UNK]", "<|begin_of_text|>")
             if tok.token_to_id(t) is not None]
    texts = TEXTS[:30] + [f"a{t}b {t}" for t in added] + [_docs()[1][:1200]]
    for offsets in (None, "char", "byte"):
        fast = [tok._encode_one(t, offsets) for t in texts]
        tok._fast = False  # the general pipeline on the same tokenizer
        general = [tok._encode_one(t, offsets) for t in texts]
        tok._fast = True
        for f, g, t in zip(fast, general, texts):
            assert _fields(f) == _fields(g) if offsets else f.ids == g.ids, (config, offsets, t)


def test_training_feed_and_merges():
    """A Punctuation/Digits pipeline: the words fed to the trainer are
    those of JAX's feed, and BpeTrainer's vocab and merges JAX's and the
    wheel's."""
    from tokenizers_tpu_torch.models.bpe import BPE
    from tokenizers_tpu_torch.pre_tokenizers import Digits, Punctuation, Sequence, WhitespaceSplit
    from tokenizers_tpu_torch.trainers import BpeTrainer

    with open(os.path.join(REPO, "tests", "fixtures", "corpus.txt"), encoding="utf-8") as f:
        lines = [ln + "\n" for ln in f.read()[:6_000].split("\n")]
    ours = Tokenizer(BPE(), device="cpu")
    ours.normalizer = None
    ours.pre_tokenizer = Sequence([WhitespaceSplit(), Punctuation(), Digits(True)])
    jax = tt.Tokenizer(tt.models.BPE())
    jax.pre_tokenizer = tt.pre_tokenizers.Sequence([
        tt.pre_tokenizers.WhitespaceSplit(), tt.pre_tokenizers.Punctuation(),
        tt.pre_tokenizers.Digits(True)])
    for line in lines:
        p = jax.added_vocabulary.extract_and_normalize(None, line)
        jax.pre_tokenizer.pre_tokenize(p)
        assert ours.train_words(line) == [s for s, _o, _t in p.get_splits("original", "byte")]
    ours.train_from_iterator(lines, BpeTrainer(vocab_size=150, device="cpu"))
    wheel = hf.Tokenizer(hf.models.BPE())
    wheel.pre_tokenizer = hf.pre_tokenizers.Sequence([
        hf.pre_tokenizers.WhitespaceSplit(), hf.pre_tokenizers.Punctuation(),
        hf.pre_tokenizers.Digits(individual_digits=True)])
    wheel.train_from_iterator(lines, hf.trainers.BpeTrainer(vocab_size=150, show_progress=False))
    jax.train_from_iterator(lines, tt.trainers.BpeTrainer(vocab_size=150, show_progress=False))
    model = json.loads(ours.to_str())["model"]
    assert model == json.loads(wheel.to_str())["model"] == json.loads(jax.to_str())["model"]


def test_to_str_of_every_component_equals_the_wheels():
    blobs = [_blob(n) for n in HOST_PIPELINES if n != "qwen2_shape"]
    blobs.append(_char_bpe_with(
        normalizer={"type": "Sequence", "normalizers": [
            {"type": "ByteLevel"}, {"type": "Replace", "pattern": {"Regex": r"\s+"},
                                    "content": " "}]},
        pre_tokenizer={"type": "Sequence", "pretokenizers": [
            {"type": "CharDelimiterSplit", "delimiter": "x"},
            {"type": "Split", "pattern": {"Regex": r"\p{N}|(?i:'s)"}, "behavior": "Isolated",
             "invert": False},
            {"type": "FixedLength", "length": 7},
            {"type": "Split", "pattern": {"String": "ab"}, "behavior": "MergedWithNext",
             "invert": True},
            {"type": "Punctuation", "behavior": "Contiguous"},
            {"type": "Metaspace", "replacement": "_", "prepend_scheme": "first",
             "split": False}]}))
    for blob in blobs:
        assert Tokenizer.from_str(blob, device="cpu").to_str() == hf.Tokenizer.from_str(
            blob).to_str()


def test_recipes_once_refused():
    gpt2 = json.loads(config_json("gpt2"))["model"]
    args = (gpt2["vocab"], [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                            for m in gpt2["merges"]])
    ours = port_recipes.ByteLevelBPETokenizer(*args, lowercase=True, device="cpu")
    theirs = wheel_recipes.ByteLevelBPETokenizer(*args, lowercase=True)
    assert ours._tokenizer._get_device_engine() is None
    for g, w in zip(ours.encode_batch(TEXTS), theirs.encode_batch(TEXTS)):
        assert _fields(g) == _fields(w)
    ours = port_recipes.ByteLevelBPETokenizer(*args, dropout=1.0, device="cpu")
    theirs = wheel_recipes.ByteLevelBPETokenizer(*args, dropout=1.0)
    assert [e.ids for e in ours.encode_batch(TEXTS)] == [e.ids for e in theirs.encode_batch(TEXTS)]


@pytest.mark.parametrize("name", ENGINE_PIPELINES)
def test_engine_pipeline_equals_wheel(name):
    """Through the byte-level engine (the plain kernel versions on the
    CPU); llama3 with a prefix space puts each piece's space on the device
    (`bpe_encode.prefix_pieces`), where JAX's engine prepends one space to
    the whole text and departs from the wheel."""
    blob = _blob(name)
    docs = [d[:1500] for d in _docs()[::200]] + TEXTS[:12]
    ours, wheel = Tokenizer.from_str(blob, device="cpu"), hf.Tokenizer.from_str(blob)
    assert type(ours._get_device_engine()).__name__ == "ByteLevelBpeEngine"
    assert [e.ids for e in ours.encode_batch_fast(docs)] == \
        [e.ids for e in wheel.encode_batch_fast(docs)]
    for g, w in zip(ours.encode_batch(docs), wheel.encode_batch(docs)):
        assert _fields(g) == _fields(w)
    if name == "llama3_prefix":
        from tokenizers_tpu.ops.bpe_engine import ByteLevelBpeEngine

        jax = tt.Tokenizer.from_str(blob)
        eng = object.__new__(ByteLevelBpeEngine)
        eng.add_prefix_space = True  # as JAX's try_build sets it here (bpe_engine.py:133)
        text = "abc 123\nfoo!! bar"
        # JAX's engine prepares the whole text with one space, then splits:
        # " 123" is no llama-3 piece, so its ids differ from the wheel's
        assert eng._prepare(text) == b" " + text.encode()
        assert jax._encode(text, None, True, "none").ids == wheel.encode(text).ids == \
            ours.encode_batch_fast([text])[0].ids
