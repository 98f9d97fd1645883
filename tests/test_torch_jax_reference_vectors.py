"""The reference's own integration edge-case vectors, run live against the
installed reference wheel as oracle (VERDICT r1 item 10).

Cases ported from:
  /root/reference/tokenizers/tests/offsets.rs:13-187
  /root/reference/tokenizers/tests/added_tokens.rs:7-124
  /root/reference/tokenizers/tests/unigram.rs:12-40 (Japanese text)

The reference tests run on downloaded full gpt2/bert vocabs (unavailable
offline); the *behaviors* under test — offset trimming, dual sequences,
pre-tokenized input, added-token stripping/single_word/overlap — are vocab-
independent, so both sides are built from the committed fixture vocabs and
their full Encodings must agree."""

import pytest
import tokenizers as hf

import tokenizers_tpu_torch as tpu

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)

GPT2 = "tests/fixtures/gpt2/tokenizer.json"
BERT = "tests/fixtures/bert/tokenizer.json"
UNIGRAM = "tests/fixtures/unigram/tokenizer.json"


def assert_same(ours, theirs, input_str=None):
    assert ours.ids == theirs.ids, (input_str, ours.tokens, theirs.tokens)
    assert ours.tokens == theirs.tokens, input_str
    assert ours.offsets == [tuple(o) for o in theirs.offsets], (
        input_str,
        ours.tokens,
    )
    assert ours.word_ids == theirs.word_ids, input_str
    assert ours.type_ids == theirs.type_ids, input_str
    assert (
        ours.special_tokens_mask == theirs.special_tokens_mask
    ), input_str
    assert ours.attention_mask == theirs.attention_mask, input_str


def get_byte_level(add_prefix_space, trim_offsets):
    """tests/common/mod.rs:23-33 rebuilt on the fixture vocab."""
    pair = []
    for lib in (tpu, hf):
        tok = lib.Tokenizer.from_file(GPT2)
        tok.pre_tokenizer = lib.pre_tokenizers.ByteLevel(
            add_prefix_space=add_prefix_space
        )
        tok.decoder = lib.decoders.ByteLevel()
        tok.post_processor = lib.processors.ByteLevel(
            trim_offsets=trim_offsets
        )
        pair.append(tok)
    return pair


def get_bert():
    """tests/common/mod.rs:43-57 rebuilt on the fixture vocab."""
    pair = []
    for lib in (tpu, hf):
        tok = lib.Tokenizer.from_file(BERT)
        tok.post_processor = None
        pair.append(tok)
    return pair


def encode_both(pair, seq, pair_seq=None, add_special_tokens=False):
    ours = pair[0].encode(
        seq, pair=pair_seq, add_special_tokens=add_special_tokens
    )
    theirs = pair[1].encode(
        seq, pair=pair_seq, add_special_tokens=add_special_tokens
    )
    return ours, theirs


# ------------------------------------------------------------- offsets.rs


@pytest.mark.parametrize("trim", [False, True])
def test_byte_level_basic(trim):
    pair = get_byte_level(True, trim)
    s = "Hello there, how are you?"
    assert_same(*encode_both(pair, s), s)
    # trimmed offsets must point at the space-free text
    ours = pair[0].encode(s, add_special_tokens=False)
    spans = [s[a:b] for a, b in ours.offsets]
    if trim:
        assert all(not sp.startswith(" ") for sp in spans), spans


def test_byte_level_unicode():
    pair = get_byte_level(True, False)
    s = "i⭢j"
    ours, theirs = encode_both(pair, s)
    assert_same(ours, theirs, s)
    # every byte-piece of the 3-byte arrow maps to the full char span
    arrow = [k for k, t in enumerate(ours.tokens) if "⭢" not in s[:1]]
    assert ours.offsets == theirs.offsets


def test_byte_level_double_sequence():
    pair = get_byte_level(True, False)
    ours, theirs = encode_both(pair, "My name is Anthony", "What is my name?")
    assert_same(ours, theirs)
    n_a = sum(1 for t in ours.type_ids if t == 0)
    assert set(ours.type_ids) == {0, 1}

    pair = get_byte_level(True, True)
    ours, theirs = encode_both(pair, "My name is Anthony", "What is my name?")
    assert_same(ours, theirs)


def test_byte_level_pre_tokenized_sequence():
    pair = get_byte_level(True, False)
    inp = ["My", "name", "is", "Anthonino"]
    ours = pair[0].encode(inp, is_pretokenized=True, add_special_tokens=False)
    theirs = pair[1].encode(
        inp, is_pretokenized=True, add_special_tokens=False
    )
    assert_same(ours, theirs, inp)


def test_split_on_added_tokens_bert():
    pair = get_bert()
    for tok, lib in zip(pair, (tpu, hf)):
        tok.add_special_tokens([lib.AddedToken("[MASK]", special=True)])
    s = "Yesterday I saw a [MASK] far away"
    ours, theirs = encode_both(pair, s)
    assert_same(ours, theirs, s)
    assert "[MASK]" in ours.tokens
    k = ours.tokens.index("[MASK]")
    assert s[slice(*ours.offsets[k])] == "[MASK]"


# --------------------------------------------------------- added_tokens.rs


def _added(lib, value, special=True, **kw):
    return lib.AddedToken(value, special=special, **kw)


def test_add_tokens():
    pair = get_bert()
    for tok, lib in zip(pair, (tpu, hf)):
        n = tok.add_special_tokens(
            [_added(lib, "<cls>"), _added(lib, "<sep>")]
        )
        assert n == 2
        n = tok.add_tokens(
            [_added(lib, "hello", special=False), _added(lib, "world", special=False)]
        )
        assert n == 2
    ours, theirs = encode_both(pair, "hello<cls>world<sep>")
    assert_same(ours, theirs)


@pytest.mark.parametrize("side", ["lstrip", "rstrip"])
def test_strip_tokens(side):
    pair = get_bert()
    kw = {side: True}
    for tok, lib in zip(pair, (tpu, hf)):
        tok.add_special_tokens([_added(lib, "<mask>", **kw)])
    s = "I saw a <mask> 😺"
    ours, theirs = encode_both(pair, s)
    assert_same(ours, theirs, s)
    # the stripped whitespace is swallowed into the added token's span
    # (reference added_tokens.rs:32-60: the token value is " <mask>" /
    # "<mask> ")
    k = next(i for i, t in enumerate(ours.tokens) if "<mask>" in t)
    span = s[slice(*ours.offsets[k])]
    if side == "lstrip":
        assert span == " <mask>"
    else:
        assert span == "<mask> "


def test_rstrip_with_byte_level_prefix_space():
    # offsets.rs:62-75 — with add_prefix_space the rstrip token's span
    pair = get_byte_level(True, False)
    for tok, lib in zip(pair, (tpu, hf)):
        tok.add_special_tokens([_added(lib, "<mask>", rstrip=True)])
    s = "I saw a <mask> 😺"
    assert_same(*encode_both(pair, s), s)


@pytest.mark.parametrize("single_word", [True, False])
def test_single_word_tokens(single_word):
    pair = get_bert()
    for tok, lib in zip(pair, (tpu, hf)):
        tok.add_special_tokens(
            [_added(lib, "ing", single_word=single_word)]
        )
    s = "I like dancing"
    ours, theirs = encode_both(pair, s)
    assert_same(ours, theirs, s)
    if single_word:
        assert "ing" not in ours.tokens
    else:
        assert "ing" in ours.tokens


def test_overlapping_tokens():
    pair = get_bert()
    for tok, lib in zip(pair, (tpu, hf)):
        tok.add_special_tokens([_added(lib, "danc")])
        tok.add_special_tokens([_added(lib, "nci")])
        tok.add_special_tokens([_added(lib, "ing")])
    s = "I like dancing"
    assert_same(*encode_both(pair, s), s)

    pair = get_bert()
    for tok, lib in zip(pair, (tpu, hf)):
        tok.add_special_tokens([_added(lib, "nci")])
        tok.add_special_tokens([_added(lib, "danc")])
        tok.add_special_tokens([_added(lib, "ing")])
        tok.add_special_tokens([_added(lib, "ike")])
    assert_same(*encode_both(pair, s), s)


# -------------------------------------------------------------- unigram.rs


def test_unigram_japanese():
    """unigram.rs:12-40 — the fixture vocab is English-trained, so the
    Japanese text exercises the unk/byte path; both sides must agree."""
    ours_tok = tpu.Tokenizer.from_file(UNIGRAM)
    ref_tok = hf.Tokenizer.from_file(UNIGRAM)
    s = "吾輩《わがはい》は猫である。名前はまだ無い。"
    ours = ours_tok.encode(s, add_special_tokens=False)
    theirs = ref_tok.encode(s, add_special_tokens=False)
    assert_same(ours, theirs, s)
