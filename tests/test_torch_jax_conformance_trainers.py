"""Trainer conformance: our trainers reproduce the reference's learned vocabs."""

import os

import tokenizers as hf

import tokenizers_tpu_torch as tt

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def corpus_lines(n=3000):
    with open(os.path.join(HERE, "corpus.txt"), encoding="utf-8") as f:
        return [next(f) for _ in range(n)]


def test_bpe_trainer_matches_reference():
    lines = corpus_lines()

    ref = hf.Tokenizer(hf.models.BPE())
    ref.pre_tokenizer = hf.pre_tokenizers.Whitespace()
    ref.train_from_iterator(
        lines,
        hf.trainers.BpeTrainer(vocab_size=800, special_tokens=["<unk>"], show_progress=False),
    )

    mine = tt.Tokenizer(tt.models.BPE())
    mine.pre_tokenizer = tt.pre_tokenizers.Whitespace()
    mine.train_from_iterator(
        lines, tt.trainers.BpeTrainer(vocab_size=800, special_tokens=["<unk>"])
    )

    assert mine.get_vocab() == ref.get_vocab()
    # merge lists must be identical too (content + order)
    ref_merges = hf.Tokenizer.from_str(ref.to_str())
    import json

    rm = json.loads(ref.to_str())["model"]["merges"]
    mm = json.loads(mine.to_str())["model"]["merges"]
    assert [tuple(x) for x in mm] == [tuple(x) for x in rm]

    for s in ["the quick brown fox", "hello worlds", "tokenization"]:
        assert mine.encode(s).ids == ref.encode(s).ids


def test_bpe_trainer_max_token_length_and_limits():
    lines = corpus_lines(1500)
    kw = dict(
        vocab_size=400,
        min_frequency=2,
        max_token_length=4,
        limit_alphabet=60,
        show_progress=False,
    )
    ref = hf.Tokenizer(hf.models.BPE())
    ref.pre_tokenizer = hf.pre_tokenizers.Whitespace()
    ref.train_from_iterator(lines, hf.trainers.BpeTrainer(**kw))

    kw.pop("show_progress")
    mine = tt.Tokenizer(tt.models.BPE())
    mine.pre_tokenizer = tt.pre_tokenizers.Whitespace()
    mine.train_from_iterator(lines, tt.trainers.BpeTrainer(**kw))
    assert mine.get_vocab() == ref.get_vocab()


def test_wordpiece_trainer_matches_reference():
    lines = corpus_lines(1500)
    ref = hf.Tokenizer(hf.models.WordPiece(unk_token="[UNK]"))
    ref.normalizer = hf.normalizers.BertNormalizer()
    ref.pre_tokenizer = hf.pre_tokenizers.BertPreTokenizer()
    ref.train_from_iterator(
        lines,
        hf.trainers.WordPieceTrainer(
            vocab_size=600, special_tokens=["[PAD]", "[UNK]"], show_progress=False
        ),
    )

    mine = tt.Tokenizer(tt.models.WordPiece(unk_token="[UNK]"))
    mine.normalizer = tt.normalizers.BertNormalizer()
    mine.pre_tokenizer = tt.pre_tokenizers.BertPreTokenizer()
    mine.train_from_iterator(
        lines,
        tt.trainers.WordPieceTrainer(vocab_size=600, special_tokens=["[PAD]", "[UNK]"]),
    )
    # NB: with a continuing_subword_prefix, the reference assigns ids to
    # derived (##-prefixed) subwords in AHashMap iteration order, and merge
    # count-ties break on those ids — so merge selection under ties is not
    # reproducible across implementations (nor across reference builds).
    # We check structural agreement instead: same vocab size, same alphabet,
    # and high overlap of learned pieces; plus our own run is deterministic.
    ref_vocab, my_vocab = set(ref.get_vocab()), set(mine.get_vocab())
    assert len(my_vocab) == len(ref_vocab)
    overlap = len(my_vocab & ref_vocab) / len(ref_vocab)
    assert overlap > 0.95, overlap

    mine2 = tt.Tokenizer(tt.models.WordPiece(unk_token="[UNK]"))
    mine2.normalizer = tt.normalizers.BertNormalizer()
    mine2.pre_tokenizer = tt.pre_tokenizers.BertPreTokenizer()
    mine2.train_from_iterator(
        lines,
        tt.trainers.WordPieceTrainer(vocab_size=600, special_tokens=["[PAD]", "[UNK]"]),
    )
    assert mine2.get_vocab() == mine.get_vocab()


def test_wordlevel_trainer_matches_reference():
    lines = corpus_lines(1000)
    ref = hf.Tokenizer(hf.models.WordLevel(unk_token="<unk>"))
    ref.pre_tokenizer = hf.pre_tokenizers.Whitespace()
    ref.train_from_iterator(
        lines,
        hf.trainers.WordLevelTrainer(
            vocab_size=500, min_frequency=2, special_tokens=["<unk>"], show_progress=False
        ),
    )
    mine = tt.Tokenizer(tt.models.WordLevel(unk_token="<unk>"))
    mine.pre_tokenizer = tt.pre_tokenizers.Whitespace()
    mine.train_from_iterator(
        lines,
        tt.trainers.WordLevelTrainer(vocab_size=500, min_frequency=2, special_tokens=["<unk>"]),
    )
    assert mine.get_vocab() == ref.get_vocab()
