"""`tools.EncodingVisualizer` of the port against the JAX package's, on
the fixtures: the port's visualizer over the port's tokenizer gives the
HTML that the JAX package's visualizer gives over the same encodings
(the wheel's, which the port's equal: the JAX visualizer reads only
`encode(text)`'s offsets and special tokens mask, so no JAX program
runs)."""

import json

import pytest
from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.tools.visualizer import Annotation as JaxAnnotation
from tokenizers_tpu.tools.visualizer import EncodingVisualizer as JaxVisualizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.smoke_data import T5_SHAPE, host_pipelines
from tokenizers_tpu_torch.tools import Annotation, EncodingVisualizer

TEXTS = ["Hello world! <b>bold</b> & co.", "naïve café ＡＢＣ x²y", "序号 中文  日本語",
         "a [SEP] b <|endoftext|> c", ""]
SPANS = [(0, 5, "greeting"), (3, 12, "overlap"), (6, 8, "PER")]


def _blob(name):
    if name == T5_SHAPE:
        return host_pipelines()[T5_SHAPE]
    with open(f"tests/fixtures/{name}/tokenizer.json", encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("name", ["gpt2", "bert", "unigram", T5_SHAPE])
def test_html_equals_jax(name):
    blob = _blob(name)
    ours = Tokenizer.from_str(blob, device="cpu")
    wheel = WheelTokenizer.from_str(blob)
    for text in TEXTS:
        g, w = ours.encode(text), wheel.encode(text)
        assert (g.offsets, g.special_tokens_mask) == ([tuple(o) for o in w.offsets],
                                                      w.special_tokens_mask), text
        spans = [s for s in SPANS if s[1] <= len(text)]
        got = EncodingVisualizer(ours)(text, [Annotation(*s) for s in spans])
        want = JaxVisualizer(wheel)(text, [JaxAnnotation(*s) for s in spans])
        assert got == want, text


def test_converter_and_notebook_flag():
    ours = Tokenizer.from_str(_blob("bert"), device="cpu")
    viz = EncodingVisualizer(ours, annotation_converter=lambda d: Annotation(**d))
    html = viz("Hello world", [{"start": 0, "end": 5, "label": "x"}])
    assert 'class="annotation-label"' in html and ">x</span>" in html
    assert json.dumps(EncodingVisualizer.unk_token_regex()) == "null"
