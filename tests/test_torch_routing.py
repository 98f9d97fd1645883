"""Routing, on the CPU: for each pipeline of `smoke_data.host_pipelines()`
(phase 16 of `chip_smoke.py`) and each fixture and frozen tokenizer, the
port's engine class (or None) is the one the JAX package's
`build_device_engine` picks.  The JAX byte-level engine's merge tables
(hundreds of thousands of merges in Python for llama3) and its engine
object are stubbed: its predicates, its byte alphabet and its whole-word
collision check still decide, and nothing of JAX is compiled.  The three
pipelines on the llama3_128k model load it once a library and take their
normalizer and pre-tokenizer through the settable components."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tokenizers_tpu as tt  # noqa: E402
from tokenizers_tpu import serialization as jser  # noqa: E402
from tokenizers_tpu.ops.engine import build_device_engine  # noqa: E402
from tokenizers_tpu_torch import Tokenizer  # noqa: E402
from tokenizers_tpu_torch import normalizers as port_normalizers  # noqa: E402
from tokenizers_tpu_torch import pre_tokenizers as port_pre_tokenizers  # noqa: E402
from tokenizers_tpu_torch.smoke_data import ENGINE_PIPELINES, HOST_PIPELINES  # noqa: E402
from test_torch_host_pipelines import CONFIGS, _blob  # noqa: E402


def _class(engine):
    return None if engine is None else type(engine).__name__


class _Stub:
    """Stands in for the JAX byte-level engine's merge tables and for the
    engine itself: its routing is decided before them."""

    def __init__(self, *args, **kw):
        self.args = args


_LLAMA3 = {}


def _tokenizers(name):
    """(port, JAX) tokenizers of pipeline `name`."""
    blob = _blob(name)
    if name not in ("llama3", "llama3_prefix", "qwen2_shape"):
        return Tokenizer.from_str(blob, device="cpu"), tt.Tokenizer.from_str(blob)
    if not _LLAMA3:
        _LLAMA3["pair"] = (Tokenizer.from_str(_blob("llama3"), device="cpu"),
                           tt.Tokenizer.from_str(_blob("llama3")))
    ours, theirs = _LLAMA3["pair"]
    d = json.loads(blob)
    ours.normalizer = port_normalizers.from_json(d["normalizer"])
    ours.pre_tokenizer = port_pre_tokenizers.from_json(d["pre_tokenizer"])
    theirs.normalizer = jser.normalizer_from_dict(d["normalizer"])
    theirs.pre_tokenizer = jser.pre_tokenizer_from_dict(d["pre_tokenizer"])
    return ours, theirs


def _jax_routing(theirs, monkeypatch):
    from tokenizers_tpu.ops import bpe_engine as jbe

    monkeypatch.setattr(jbe, "CuckooMergeTable", _Stub)
    monkeypatch.setattr(jbe, "consume_mins", lambda *a: None)
    monkeypatch.setattr(jbe.ByteLevelBpeEngine, "__init__", _Stub.__init__)
    return build_device_engine(theirs)


@pytest.mark.parametrize("name", list(HOST_PIPELINES + ENGINE_PIPELINES + CONFIGS)
                         + ["llama3_small"])
def test_routing_equals_jax(name, monkeypatch):
    ours, theirs = _tokenizers(name)
    assert _class(ours._get_device_engine()) == _class(_jax_routing(theirs, monkeypatch)), name
