"""Shared check of the port's loader against the references: a pipeline
the JAX package loads, the port loads and encodes as the `tokenizers`
wheel does (ids, tokens, char offsets, word ids, type ids, attention
mask), or raises where the wheel raises; under BPE dropout it encodes as
the JAX package does with the same seed (the port's model drawing from
its own `random.Random`); a model the wheel cannot build (it panics)
the port refuses too; a `Precompiled` normalizer encodes as the wheel
does, and a charsmap the wheel refuses, JAX and the port refuse with
ValueError."""

import json
import random

import pytest
import tokenizers as hf

import tokenizers_tpu as tt
from tokenizers_tpu_torch import Tokenizer

TEXTS = ["Hello world! y'all'll've 12345", "naïve café ＡＢＣ x²y ½z", "a\n\n  b\tc",
         "序号 中文 日本語のテキスト", "", "Don'ſ  STOP!!"]


def loads_as_the_reference(blob: str, texts=TEXTS) -> None:
    d = json.loads(blob)
    try:
        ref = hf.Tokenizer.from_str(blob)
    except BaseException as e:  # a Rust panic is no Exception
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        if "Precompiled" in json.dumps(d.get("normalizer")):
            with pytest.raises(ValueError):
                tt.Tokenizer.from_str(blob)
            with pytest.raises(ValueError):
                Tokenizer.from_str(blob, device="cpu")
            return
        with pytest.raises(Exception):
            Tokenizer.from_str(blob, device="cpu")
        return
    ours = Tokenizer.from_str(blob, device="cpu")
    if d["model"].get("dropout"):
        theirs = tt.Tokenizer.from_str(blob)
        for seed, text in enumerate(texts):
            ours.model.rng = random.Random(seed)
            random.seed(seed)
            g, j = ours.encode(text), theirs.encode(text)
            assert (g.ids, g.tokens, g.offsets) == (j.ids, j.tokens, j.offsets), text
        return
    try:
        want = ref.encode_batch(texts)
    except Exception:
        with pytest.raises(Exception):
            ours.encode_batch(texts)
        return
    got = ours.encode_batch(texts)
    for g, w, t in zip(got, want, texts):
        assert (g.ids, g.tokens, g.offsets, g.word_ids, g.type_ids, g.attention_mask) == (
            w.ids, w.tokens, [tuple(o) for o in w.offsets], w.word_ids, w.type_ids,
            w.attention_mask), t
    assert [e.ids for e in ours.encode_batch_fast(texts)] == [e.ids for e in want]
