"""Normalizer conformance vs the reference implementation (pip `tokenizers`)."""

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
    hfn = hf.normalizers
    ttn = tt.normalizers
    yield "nfd", hfn.NFD(), ttn.NFD()
    yield "nfkd", hfn.NFKD(), ttn.NFKD()
    yield "nfc", hfn.NFC(), ttn.NFC()
    yield "nfkc", hfn.NFKC(), ttn.NFKC()
    yield "lowercase", hfn.Lowercase(), ttn.Lowercase()
    yield "nmt", hfn.Nmt(), ttn.Nmt()
    yield "strip", hfn.Strip(), ttn.Strip()
    yield "strip_l", hfn.Strip(right=False), ttn.Strip(right=False)
    yield "strip_r", hfn.Strip(left=False), ttn.Strip(left=False)
    yield "strip_accents", hfn.StripAccents(), ttn.StripAccents()
    yield "prepend", hfn.Prepend("▁"), ttn.Prepend("▁")
    yield "replace_str", hfn.Replace(" ", "▁"), ttn.Replace(" ", "▁")
    yield (
        "replace_re",
        hfn.Replace(hf.Regex(r"\s+"), " "),
        ttn.Replace(("Regex", r"\s+"), " "),
    )
    yield "bert", hfn.BertNormalizer(), ttn.BertNormalizer()
    yield (
        "bert_nostrip",
        hfn.BertNormalizer(strip_accents=False, lowercase=False),
        ttn.BertNormalizer(strip_accents=False, lowercase=False),
    )
    yield "bytelevel", hfn.ByteLevel(), ttn.ByteLevel()
    yield (
        "sequence",
        hfn.Sequence([hfn.NFD(), hfn.Lowercase(), hfn.StripAccents()]),
        ttn.Sequence([ttn.NFD(), ttn.Lowercase(), ttn.StripAccents()]),
    )


@pytest.mark.parametrize("name,ref,mine", list(pairs()), ids=lambda x: x if isinstance(x, str) else "")
def test_normalize_str(name, ref, mine):
    for s in SHORT_STRINGS:
        assert mine.normalize_str(s) == ref.normalize_str(s), (name, s)


def test_full_unicode_nfd_nfc_sweep():
    """Spot-sweep codepoint blocks through NFC/NFD for string equality."""
    import unicodedata

    ttn = tt.normalizers
    chunks = []
    for base in [0x0040, 0x00C0, 0x0390, 0x1E00, 0x3040, 0xAC00, 0xFB00, 0x1F600]:
        chars = []
        for cp in range(base, base + 192):
            c = chr(cp)
            if unicodedata.category(c).startswith(("C", "Z")):
                continue
            chars.append(c)
        chunks.append("".join(chars))
    for s in chunks:
        assert ttn.NFD().normalize_str(s) == unicodedata.normalize("NFD", s)
        assert ttn.NFC().normalize_str(s) == unicodedata.normalize("NFC", s)
        assert ttn.NFKD().normalize_str(s) == unicodedata.normalize("NFKD", s)
        assert ttn.NFKC().normalize_str(s) == unicodedata.normalize("NFKC", s)
