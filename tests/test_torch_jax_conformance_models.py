"""Model conformance vs the reference on handwritten vocabs."""

import tokenizers as hf

import tokenizers_tpu_torch as tt

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)

WORDS = [
    "hello", "world", "unbelievable", "a", "ab", "abc", "abcdefgh",
    "ababab", "aaaa", "xyz", "éa", "日本", "don't", "123", "",
    "supercalifragilistic", "ltltltlt",
]


def _bpe_vocab():
    # vocab over a small alphabet with layered merges
    tokens = list("abcdefghijklmnopqrstuvwxyz'é日本123") + [
        "ab", "ba", "abab", "lt", "ltlt", "he", "ll", "llo", "hello",
        "un", "be", "li", "ev", "unbe", "able", "<unk>",
    ]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    merges = [
        ("a", "b"), ("b", "a"), ("ab", "ab"), ("l", "t"), ("lt", "lt"),
        ("h", "e"), ("l", "l"), ("ll", "o"), ("he", "llo"),
        ("u", "n"), ("b", "e"), ("l", "i"), ("e", "v"), ("un", "be"),
    ]
    return vocab, merges


def test_bpe_basic():
    vocab, merges = _bpe_vocab()
    mine = tt.models.BPE(vocab, merges, unk_token="<unk>")
    ref = hf.models.BPE(vocab, merges, unk_token="<unk>")
    t_mine, t_ref = tt.Tokenizer(mine), hf.Tokenizer(ref)
    for w in WORDS:
        em, er = t_mine.encode(w), t_ref.encode(w)
        assert em.ids == er.ids, (w, em.tokens, er.tokens)
        assert em.tokens == er.tokens
        assert em.offsets == er.offsets


def test_bpe_unk_fuse_and_ignore_merges():
    vocab, merges = _bpe_vocab()
    for kwargs in [
        dict(unk_token="<unk>", fuse_unk=True),
        dict(unk_token="<unk>", fuse_unk=False),
        dict(unk_token="<unk>", ignore_merges=True),
        dict(),
    ]:
        mine = tt.Tokenizer(tt.models.BPE(vocab, merges, **kwargs))
        ref = hf.Tokenizer(hf.models.BPE(vocab, merges, **kwargs))
        for w in WORDS + ["hello✓world", "✓✓✓", "hello"]:
            em, er = mine.encode(w), ref.encode(w)
            assert em.ids == er.ids, (kwargs, w, em.tokens, er.tokens)
            assert em.offsets == er.offsets, (kwargs, w)


def test_bpe_prefix_suffix():
    # wordpiece-style BPE with continuing prefix and end-of-word suffix
    base = list("abcdehlort") + ["##a", "##b", "##c", "##l", "##o", "##e",
                                 "h##", "a</w>", "b</w>", "c</w>", "o</w>",
                                 "hell", "hell##", "##ll", "##llo", "<unk>"]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(base))}
    merges = [("h", "##e"), ("##l", "##l")]
    # build new tokens required by merges: "h##e"? prefix strip: "h" + "e" = "he"
    vocab.setdefault("he", len(vocab))
    vocab.setdefault("##ll", len(vocab))
    mine = tt.Tokenizer(
        tt.models.BPE(vocab, merges, unk_token="<unk>", continuing_subword_prefix="##")
    )
    ref = hf.Tokenizer(
        hf.models.BPE(vocab, merges, unk_token="<unk>", continuing_subword_prefix="##")
    )
    for w in ["hello", "hell", "abc", "x", "hl"]:
        em, er = mine.encode(w), ref.encode(w)
        assert em.ids == er.ids, (w, em.tokens, er.tokens)


def test_bpe_byte_fallback():
    vocab = {f"<0x{b:02X}>": b for b in range(256)}
    n = len(vocab)
    for i, t in enumerate(["a", "b", "ab", "<unk>"]):
        vocab[t] = n + i
    merges = [("a", "b")]
    mine = tt.Tokenizer(tt.models.BPE(vocab, merges, byte_fallback=True, unk_token="<unk>"))
    ref = hf.Tokenizer(hf.models.BPE(vocab, merges, byte_fallback=True, unk_token="<unk>"))
    for w in ["ab", "abc", "日本", "aé日b"]:
        em, er = mine.encode(w), ref.encode(w)
        assert em.ids == er.ids, (w, em.tokens, er.tokens)
        assert em.offsets == er.offsets, (w, em.offsets, er.offsets)


def test_wordpiece():
    base = ["[UNK]", "[CLS]", "[SEP]", "want", "##want", "##ed", "wa", "un",
            "runn", "##ing", "runn##", "the", "a", "##a", "##n"]
    vocab = {t: i for i, t in enumerate(base)}
    mine = tt.Tokenizer(tt.models.WordPiece(vocab, unk_token="[UNK]"))
    ref = hf.Tokenizer(hf.models.WordPiece(vocab, unk_token="[UNK]"))
    for w in ["want", "wanted", "unwanted", "running", "xyz", "wa", "waa",
              "a" * 101, "thea"]:
        em, er = mine.encode(w), ref.encode(w)
        assert em.ids == er.ids, (w, em.tokens, er.tokens)
        assert em.offsets == er.offsets


def test_wordlevel():
    vocab = {"<unk>": 0, "hello": 1, "world": 2}
    mine = tt.Tokenizer(tt.models.WordLevel(vocab, unk_token="<unk>"))
    ref = hf.Tokenizer(hf.models.WordLevel(vocab, unk_token="<unk>"))
    mine.pre_tokenizer = tt.pre_tokenizers.WhitespaceSplit()
    ref.pre_tokenizer = hf.pre_tokenizers.WhitespaceSplit()
    for s in ["hello world", "hello xyz world", ""]:
        em, er = mine.encode(s), ref.encode(s)
        assert em.ids == er.ids
        assert em.offsets == er.offsets


def test_unigram():
    pieces = [
        ("<unk>", 0.0), ("a", -1.0), ("b", -2.0), ("c", -3.0), ("d", -4.0),
        ("cd", -0.5), ("ab", -1.5), ("abc", -2.0), ("abcd", -0.5),
        ("日", -3.0), ("本", -3.0), ("日本", -2.0), ("'", -5.0),
    ]
    mine = tt.Tokenizer(tt.models.Unigram(pieces, unk_id=0))
    ref = hf.Tokenizer(hf.models.Unigram(pieces, unk_id=0, byte_fallback=False))
    for w in ["abcd", "abcdacdxx", "日本abc", "xyz", "", "ab日xc", "aaaa"]:
        em, er = mine.encode(w), ref.encode(w)
        assert em.ids == er.ids, (w, em.tokens, er.tokens)
        assert em.offsets == er.offsets, (w, em.offsets, er.offsets)


def test_unigram_byte_fallback():
    pieces = [("<unk>", 0.0), ("a", -1.0), ("b", -2.0)] + [
        (f"<0x{b:02X}>", -10.0) for b in range(256)
    ]
    mine = tt.Tokenizer(tt.models.Unigram(pieces, unk_id=0, byte_fallback=True))
    ref = hf.Tokenizer(hf.models.Unigram(pieces, unk_id=0, byte_fallback=True))
    for w in ["ab", "aXb", "日本"]:
        em, er = mine.encode(w), ref.encode(w)
        assert em.ids == er.ids, (w, em.tokens, er.tokens)
        assert em.offsets == er.offsets, (w, em.offsets, er.offsets)
