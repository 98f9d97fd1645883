"""Pre-tokenizer conformance vs the reference (splits + char offsets)."""

import pytest
import tokenizers as hf

import tokenizers_tpu_torch as tt
from corpus import SHORT_STRINGS

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)


def pairs():
    hfp = hf.pre_tokenizers
    ttp = tt.pre_tokenizers
    yield "whitespace", hfp.Whitespace(), ttp.Whitespace()
    yield "whitespace_split", hfp.WhitespaceSplit(), ttp.WhitespaceSplit()
    yield "bert", hfp.BertPreTokenizer(), ttp.BertPreTokenizer()
    yield "punct", hfp.Punctuation(), ttp.Punctuation()
    yield "punct_rm", hfp.Punctuation(behavior="removed"), ttp.Punctuation("removed")
    yield (
        "punct_mp",
        hfp.Punctuation(behavior="merged_with_previous"),
        ttp.Punctuation("merged_with_previous"),
    )
    yield (
        "punct_mn",
        hfp.Punctuation(behavior="merged_with_next"),
        ttp.Punctuation("merged_with_next"),
    )
    yield (
        "punct_ct",
        hfp.Punctuation(behavior="contiguous"),
        ttp.Punctuation("contiguous"),
    )
    yield "digits", hfp.Digits(), ttp.Digits()
    yield "digits_ind", hfp.Digits(individual_digits=True), ttp.Digits(True)
    yield "chardelim", hfp.CharDelimiterSplit(" "), ttp.CharDelimiterSplit(" ")
    yield "bytelevel", hfp.ByteLevel(), ttp.ByteLevel()
    yield (
        "bytelevel_nops",
        hfp.ByteLevel(add_prefix_space=False),
        ttp.ByteLevel(add_prefix_space=False),
    )
    yield (
        "bytelevel_nore",
        hfp.ByteLevel(use_regex=False),
        ttp.ByteLevel(use_regex=False),
    )
    yield "metaspace", hfp.Metaspace(), ttp.Metaspace()
    yield (
        "metaspace_first",
        hfp.Metaspace(prepend_scheme="first"),
        ttp.Metaspace(prepend_scheme="first"),
    )
    yield (
        "metaspace_never",
        hfp.Metaspace(prepend_scheme="never"),
        ttp.Metaspace(prepend_scheme="never"),
    )
    yield (
        "metaspace_nosplit",
        hfp.Metaspace(split=False),
        ttp.Metaspace(split=False),
    )
    yield (
        "split_str",
        hfp.Split(" ", "isolated"),
        ttp.Split(" ", "isolated"),
    )
    yield (
        "split_re_inv",
        hfp.Split(hf.Regex(r"\w+"), "removed", invert=True),
        ttp.Split(("Regex", r"\w+"), "removed", invert=True),
    )
    yield "scripts", hfp.UnicodeScripts(), ttp.UnicodeScripts()
    yield "fixed", hfp.FixedLength(5), ttp.FixedLength(5)
    yield (
        "sequence",
        hfp.Sequence([hfp.WhitespaceSplit(), hfp.Punctuation()]),
        ttp.Sequence([ttp.WhitespaceSplit(), ttp.Punctuation()]),
    )


@pytest.mark.parametrize("name,ref,mine", list(pairs()), ids=lambda x: x if isinstance(x, str) else "")
def test_pre_tokenize_str(name, ref, mine):
    for s in SHORT_STRINGS:
        assert mine.pre_tokenize_str(s) == ref.pre_tokenize_str(s), (name, s)
