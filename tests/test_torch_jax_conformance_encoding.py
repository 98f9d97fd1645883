"""Encoding mapping-helper conformance vs the reference."""

import tokenizers as hf

import tokenizers_tpu_torch as tt
from test_torch_jax_conformance_pipeline import _bert_style

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)


def test_mapping_helpers():
    ref, mine = _bert_style(True), _bert_style(False)
    for a, b in [("hello world", "the quick brown fox"), ("unbelievable", None)]:
        er = ref.encode(a, b) if b else ref.encode(a)
        em = mine.encode(a, b) if b else mine.encode(a)
        n = len(er.ids)
        for t in range(n + 2):
            assert em.token_to_sequence(t) == er.token_to_sequence(t), t
            assert em.token_to_chars(t) == (
                tuple(er.token_to_chars(t)) if er.token_to_chars(t) else None
            ), t
            assert em.token_to_word(t) == er.token_to_word(t), t
        for w in range(8):
            for seq in (0, 1):
                assert em.word_to_tokens(w, seq) == (
                    tuple(er.word_to_tokens(w, seq)) if er.word_to_tokens(w, seq) else None
                ), (w, seq)
                assert em.word_to_chars(w, seq) == (
                    tuple(er.word_to_chars(w, seq)) if er.word_to_chars(w, seq) else None
                ), (w, seq)
        for c in range(len(a) + 2):
            for seq in (0, 1):
                assert em.char_to_token(c, seq) == er.char_to_token(c, seq), (c, seq)
                assert em.char_to_word(c, seq) == er.char_to_word(c, seq), (c, seq)


def test_truncate_pad_direct():
    ref, mine = _bert_style(True), _bert_style(False)
    s = "the quick brown fox jumps over the lazy dog hello world"
    for max_len in [0, 1, 3, 5, 100]:
        for stride in [0, 1, 2]:
            if stride >= max_len and max_len != 0:
                continue
            for direction in ["left", "right"]:
                er, em = ref.encode(s), mine.encode(s)
                if stride >= max_len and max_len == 0 and stride > 0:
                    continue
                try:
                    er.truncate(max_len, stride, direction)
                    ok_ref = True
                except Exception:
                    ok_ref = False
                try:
                    em.truncate(max_len, stride, direction)
                    ok_mine = True
                except Exception:
                    ok_mine = False
                assert ok_ref == ok_mine
                if not ok_ref:
                    continue
                assert em.ids == er.ids, (max_len, stride, direction)
                assert [o.ids for o in em.overflowing] == [
                    o.ids for o in er.overflowing
                ], (max_len, stride, direction)
                em.pad(12, pad_id=9, pad_type_id=1, pad_token="[PAD]", direction=direction)
                er.pad(12, pad_id=9, pad_type_id=1, pad_token="[PAD]", direction=direction)
                assert em.ids == er.ids
                assert em.attention_mask == er.attention_mask
                assert em.type_ids == er.type_ids
