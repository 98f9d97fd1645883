"""The port's five recipes (`tokenizers_tpu_torch/implementations/`)
against the `tokenizers` wheel's and the JAX package's, on the CPU: each
trains on the first lines of `tests/fixtures/corpus.txt` at a vocab of a
few hundred through the port's trainers (`device="cpu"`), and its vocab,
merges or pieces and its `to_str` equal the wheel's and JAX's; then it
encodes and decodes as the wheel does.

Where the wheel's BPE trainer mints ids in an order of its own (a
continuing-subword prefix or an end-of-word suffix: CharBPE and
WordPiece, `.claude/skills/verify/SKILL.md`; its merges there differ from
the JAX package's, and WordPiece's from run to run) the whole `to_str` is
held against JAX's, the vocab's size against the wheel's, and the
encodings against the wheel loading the port's own string.  Unigram's
scores differ from the wheel's as the JAX package's do (its EM sums run
in another order; ROADMAP Queue C): its pieces are held exactly as a set (near-equal
scores may sort in another order), each score within the JAX package's
tolerance against the wheel (rel 1e-6, abs 1.6e-3,
`tests/test_unigram_trainer.py`) and to 1e-9 relative against JAX's, the
rest of its `to_str` exactly.  JAX's Unigram trainer
runs its host EM (`TOKENIZERS_TPU_DEVICE_EM=0`): no JAX device program is
compiled."""

import asyncio
import json
import math
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tokenizers as hf  # noqa: E402
import tokenizers.implementations as wheel_recipes  # noqa: E402

import tokenizers_tpu.implementations as jax_recipes  # noqa: E402
import tokenizers_tpu_torch.implementations as port_recipes  # noqa: E402
from corpus import SHORT_STRINGS  # noqa: E402
from test_torch_post_process import same  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TEXT = open(os.path.join(REPO, "tests", "fixtures", "corpus.txt"), encoding="utf-8").read()


def _lines(nchars):
    return [line + "\n" for line in _TEXT[:nchars].split("\n")]


def _train(name, train_kw, nchars=24_000, **kw):
    out = []
    for lib, extra in ((wheel_recipes, {}), (jax_recipes, {}), (port_recipes, {"device": "cpu"})):
        tok = getattr(lib, name)(**kw, **extra)
        tok.train_from_iterator(_lines(nchars), show_progress=False, **train_kw)
        out.append(tok)
    return out


def _encode_like(ours, wheel, texts=SHORT_STRINGS):
    for g, e, s in zip(ours.encode_batch(texts), wheel.encode_batch(texts), texts):
        same(g, e, s, nested=False)
    ids = [e.ids for e in wheel.encode_batch(texts)]
    assert ours.decode_batch(ids) == wheel.decode_batch(ids)


def test_byte_level_bpe(tmp_path):
    w, j, p = _train("ByteLevelBPETokenizer", dict(vocab_size=400,
                                                  special_tokens=["<|endoftext|>"]))
    assert p.to_str() == w.to_str() == j.to_str()
    _encode_like(p, w, SHORT_STRINGS + ["a<|endoftext|>b"])
    files = p.save_model(str(tmp_path))
    assert [os.path.basename(f) for f in files] == ["vocab.json", "merges.txt"]
    again = port_recipes.ByteLevelBPETokenizer.from_file(*files, device="cpu")
    assert again.to_str() == wheel_recipes.ByteLevelBPETokenizer.from_file(*files).to_str()
    assert [e.ids for e in again.encode_batch_fast(SHORT_STRINGS)] == \
        [e.ids for e in p.encode_batch_fast(SHORT_STRINGS)]


def test_sentencepiece_bpe():
    w, j, p = _train("SentencePieceBPETokenizer", dict(vocab_size=300))
    assert p.to_str() == w.to_str() == j.to_str()
    _encode_like(p, w)


@pytest.mark.parametrize("name", ["CharBPETokenizer", "BertWordPieceTokenizer"])
def test_suffix_and_prefix_recipes(name):
    w, j, p = _train(name, dict(vocab_size=300))
    assert len(p.get_vocab()) == len(w.get_vocab())
    assert p.to_str() == j.to_str()
    _encode_like(p, hf.Tokenizer.from_str(p.to_str()))
    if name == "BertWordPieceTokenizer":
        # with a vocab at construction, BertProcessing wraps [CLS] ... [SEP]
        vocab = p.get_vocab(with_added_tokens=False)
        ours = port_recipes.BertWordPieceTokenizer(vocab, device="cpu")
        theirs = wheel_recipes.BertWordPieceTokenizer(vocab)
        assert ours.to_str() == theirs.to_str()
        _encode_like(ours, theirs)
        pairs = [("Hello world", "the quick fox"), ("", "x")]
        for g, e, s in zip(ours.encode_batch(pairs), theirs.encode_batch(pairs), pairs):
            same(g, e, s, nested=False)


def test_sentencepiece_unigram():
    os.environ["TOKENIZERS_TPU_DEVICE_EM"] = "0"
    try:
        w, j, p = _train("SentencePieceUnigramTokenizer",
                         dict(vocab_size=150, special_tokens=["<unk>"], unk_token="<unk>"),
                         nchars=12_000)
    finally:
        del os.environ["TOKENIZERS_TPU_DEVICE_EM"]
    dw, dp = json.loads(w.to_str()), json.loads(p.to_str())
    pw, pp = dw["model"].pop("vocab"), dp["model"].pop("vocab")
    assert dp == dw
    pj = json.loads(j.to_str())["model"]["vocab"]
    assert pp[0] == pw[0] == pj[0] == ["<unk>", 0.0]
    got, want, jax = dict(pp), dict(pw), dict(pj)
    assert set(got) == set(want) == set(jax)
    for t, sw in want.items():  # near-equal scores may sort in another order
        # the JAX package's own tolerance against the wheel
        # (tests/test_unigram_trainer.py), and the port's against JAX's host EM
        assert math.isclose(got[t], sw, rel_tol=1e-6, abs_tol=1.6e-3), (t, got[t], sw)
        assert math.isclose(got[t], jax[t], rel_tol=1e-9), (t, got[t], jax[t])
    _encode_like(p, hf.Tokenizer.from_str(p.to_str()))
    # scores are read back as the wheel reads them (lossy), so a round trip
    # gives the wheel's string, not always the one written
    from tokenizers_tpu_torch import Tokenizer

    s = p.to_str()
    assert Tokenizer.from_str(s, device="cpu").to_str() == hf.Tokenizer.from_str(s).to_str()


def test_refused_options_and_async():
    """The options once refused run as the wheel's: `lowercase` and a
    `unicode_normalizer` before the byte-level model, `dropout` in every
    BPE recipe (at 1.0: no merge), and a Unigram trained without
    `unk_token` (which raises on a char outside its pieces, as the wheel
    and JAX do); then the async surface."""
    gpt2 = json.load(open(os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json"),
                          encoding="utf-8"))["model"]
    vocab = gpt2["vocab"]
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in gpt2["merges"]]
    for kw in (dict(lowercase=True), dict(lowercase=True, unicode_normalizer="nfkc")):
        ours = port_recipes.ByteLevelBPETokenizer(vocab, merges, device="cpu", **kw)
        theirs = wheel_recipes.ByteLevelBPETokenizer(vocab, merges, **kw)
        assert ours.to_str() == theirs.to_str()
        _encode_like(ours, theirs)
    for name in ("ByteLevelBPETokenizer", "CharBPETokenizer", "SentencePieceBPETokenizer"):
        w = getattr(wheel_recipes, name)()
        w.train_from_iterator(_lines(8000), vocab_size=300, show_progress=False)
        model = json.loads(w.to_str())["model"]
        args = (model["vocab"], [tuple(m) for m in model["merges"]])
        ours = getattr(port_recipes, name)(*args, dropout=1.0, device="cpu")
        theirs = getattr(wheel_recipes, name)(*args, dropout=1.0)
        assert ours.to_str() == theirs.to_str() and '"dropout":1.0' in ours.to_str()
        _encode_like(ours, theirs)
    tok = port_recipes.SentencePieceUnigramTokenizer(device="cpu")
    tok.train_from_iterator(_lines(3000), vocab_size=200, show_progress=False)
    ref = hf.Tokenizer.from_str(tok.to_str())
    assert tok.encode("hello").ids == ref.encode("hello").ids
    with pytest.raises(Exception):
        ref.encode("☃")
    with pytest.raises(ValueError, match="unk_id"):  # as the JAX package's Unigram
        tok.encode("☃")
    w, _j, p = _train("SentencePieceBPETokenizer", dict(vocab_size=280), nchars=8000)

    async def run(t):
        enc = await t.async_encode("hello world")
        batch = await t.async_encode_batch(["hello world", "foo"])
        fast = await t.async_encode_batch_fast(["hello world"])
        return enc.ids, [e.ids for e in batch], fast[0].ids, await t.async_decode(enc.ids)

    sync = p.encode("hello world").ids
    assert asyncio.run(run(p)) == (
        sync, [e.ids for e in p.encode_batch(["hello world", "foo"])], sync, p.decode(sync))
    assert sync == w.encode("hello world").ids
    assert repr(p).startswith("Tokenizer(vocabulary_size=")


@pytest.mark.parametrize("name", ["char_bpe", "sp_bpe"])
def test_recipe_json_is_the_untrained_recipe(name):
    """`smoke_data.recipe_json` builds char_bpe's and sp_bpe's untrained
    tokenizers through the port's recipes: the frozen file with no added
    tokens, vocab or merges, and the wheel's untrained recipe."""
    from tokenizers_tpu_torch.smoke_data import config_json, recipe_json

    d = json.loads(config_json(name))
    d["added_tokens"] = []
    d["model"].update(vocab={}, merges=[])
    assert json.loads(recipe_json(name)) == d
    wheel = (wheel_recipes.CharBPETokenizer() if name == "char_bpe"
             else wheel_recipes.SentencePieceBPETokenizer(fuse_unk=True))
    assert recipe_json(name) == wheel.to_str()
