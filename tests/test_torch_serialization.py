"""Serialization of the port (`serialization.py`, `Tokenizer.to_str`,
`save`, `from_str`, `from_buffer`, `from_pretrained`, pickling, the models'
`save` and `read_file`) against the `tokenizers` wheel and the JAX
package, on the CPU.  Every comparison is exact.

* `to_str` is byte-equal to JAX's and the wheel's on the six fixtures and
  the three frozen tokenizers of `tokenizers_tpu_torch/data/` (whose files
  are that string), and on pipelines with truncation, padding, added
  tokens of every option and each post-processor; `from_str(to_str())`
  gives the same string back; the wheel loads the port's string and
  encodes SHORT_STRINGS as it does from the original.
* Pickling goes through the JSON and keeps the device.
* Each model's `save` writes the files JAX's writes (byte-equal) and
  `read_file` reads them back to the same model; `BPE.read_file` reads
  the wheel's `model.save` files.
* `from_pretrained` resolves a path, a directory and a hub-cache snapshot
  with `HF_HUB_OFFLINE=1` and a temporary `HF_HUB_CACHE`, and raises when
  nothing is found (no network).
The recipes' `to_str` is held in `test_torch_implementations.py`.
"""

import filecmp
import json
import os
import pickle
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tokenizers as hf  # noqa: E402

import tokenizers_tpu as tt  # noqa: E402
from corpus import SHORT_STRINGS  # noqa: E402
from test_torch_post_process import KINDS, build  # noqa: E402
from tokenizers_tpu_torch import Tokenizer  # noqa: E402
from tokenizers_tpu_torch.added_vocabulary import AddedToken  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = ["gpt2", "bert", "llama3", "llama3_128k", "unigram", "unigram_bf"]
FROZEN = ["char_bpe", "sp_bpe", "wordlevel"]


def _path(name):
    if name in FROZEN:
        return os.path.join(REPO, "tokenizers_tpu_torch", "data", f"{name}.json")
    return os.path.join(REPO, "tests", "fixtures", name, "tokenizer.json")


@pytest.mark.parametrize("name", FIXTURES + FROZEN)
def test_to_str_byte_equal(name):
    path = _path(name)
    ours = Tokenizer.from_file(path, device="cpu")
    jax = tt.Tokenizer.from_file(path)
    s = ours.to_str()
    assert s == hf.Tokenizer.from_file(path).to_str()
    assert s == jax.to_str()
    if name in FROZEN:
        assert s == open(path, encoding="utf-8").read()
    assert Tokenizer.from_buffer(s.encode("utf-8"), device="cpu").to_str() == s
    if name != "llama3_128k":  # 128k tokens: the pretty form adds seconds, nothing more
        assert ours.to_str(pretty=True) == jax.to_str(pretty=True)
    if name in ("gpt2", "bert", "unigram", "char_bpe"):
        wheel, loaded = hf.Tokenizer.from_file(path), hf.Tokenizer.from_str(s)
        assert [e.ids for e in loaded.encode_batch(SHORT_STRINGS)] == \
            [e.ids for e in wheel.encode_batch(SHORT_STRINGS)]


def _settings(kind, tok):
    lib = {"wheel": hf, "jax": tt}.get(kind)
    added = lib.AddedToken if lib else AddedToken
    tok.enable_truncation(16, stride=2, strategy="only_first", direction="left")
    tok.enable_padding(direction="left", pad_id=1, pad_type_id=1, pad_token="[UNK]",
                       length=24, pad_to_multiple_of=8)
    tok.add_tokens(["newtok", added("single", single_word=True),
                    added("lrs", lstrip=True, rstrip=True, normalized=False)])
    tok.add_special_tokens([added("<spec>", special=True, normalized=True)])
    return tok


POSTS = {
    "template": None,
    "bert": lambda lib: lib.BertProcessing(("[SEP]", 3), ("[CLS]", 2)),
    "roberta": lambda lib: lib.RobertaProcessing(("</s>", 35), ("<s>", 34), False, False),
    "sequence": lambda lib: lib.Sequence([lib.ByteLevel(trim_offsets=False),
                                          lib.BertProcessing(("[SEP]", 3), ("[CLS]", 2))]),
}


@pytest.mark.parametrize("post", list(POSTS))
@pytest.mark.parametrize("style", ["gpt2", "bert"])
def test_to_str_with_settings(style, post):
    """Truncation, padding, added tokens of every option and each
    post-processor: the three `to_str`s are equal, each loader reads the
    port's string back to it, and the loaded tokenizers encode alike."""
    toks = [_settings(k, build(style, k, POSTS[post])) for k in KINDS]
    w, j, p = (t.to_str() for t in toks)
    assert p == w, (json.loads(p), json.loads(w))
    assert p == j
    back = Tokenizer.from_str(p, device="cpu")
    assert back.to_str() == p
    wheel = hf.Tokenizer.from_str(p)
    for s in SHORT_STRINGS[:12] + ["a newtok single lrs <spec> x"]:
        assert back.encode(s).ids == wheel.encode(s).ids == toks[0].encode(s).ids, s


def test_pickle_keeps_the_json_and_the_device():
    ours = build("gpt2", "port")
    ours.enable_truncation(8)
    ours.add_tokens([AddedToken("xy", lstrip=True)])
    back = pickle.loads(pickle.dumps(ours))
    assert back.to_str() == ours.to_str() and str(back.device) == "cpu"
    assert back.encode("hello xy world").ids == ours.encode("hello xy world").ids
    state = ours.__getstate__()
    fresh = Tokenizer.__new__(Tokenizer)
    fresh.__setstate__(state)
    assert fresh.to_str() == ours.to_str()


@pytest.mark.parametrize("name", ["gpt2", "bert", "wordlevel", "unigram"])
def test_model_save_and_read_file(name, tmp_path):
    """The files the port's `save` writes equal JAX's; `read_file` reads
    them back (and the wheel's, for BPE) to the same tokenizer.json model."""
    ours = Tokenizer.from_file(_path(name), device="cpu")
    jax = tt.Tokenizer.from_file(_path(name))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = ours.model.save(str(tmp_path / "port"), "x")
    want = jax.model.save(str(tmp_path / "jax"), "x")
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in want]
    for g, w in zip(got, want):
        assert filecmp.cmp(g, w, shallow=False), g
    model = json.loads(ours.to_str())["model"]
    cls = type(ours.model)
    if name == "gpt2":
        vocab, merges = cls.read_file(*got)
        assert vocab == model["vocab"] and [list(m) for m in merges] == model["merges"]
        (tmp_path / "wheel").mkdir()
        files = hf.Tokenizer.from_file(_path(name)).model.save(str(tmp_path / "wheel"))
        assert cls.read_file(*files) == (vocab, merges)
        assert cls.from_file(*got).get_vocab() == vocab
    elif name == "unigram":
        assert json.load(open(got[0], encoding="utf-8"))["vocab"] == model["vocab"]
    else:
        assert cls.read_file(got[0]) == model["vocab"]
        assert cls.from_file(got[0]).get_vocab_size() == len(model["vocab"])


def test_from_pretrained_offline(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    src = open(_path("bert"), encoding="utf-8").read()
    snap = tmp_path / "hub" / "models--org--bert-tiny" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (snap / "tokenizer.json").write_text(src, encoding="utf-8")
    want = Tokenizer.from_str(src, device="cpu").to_str()
    assert Tokenizer.from_pretrained("org/bert-tiny", device="cpu").to_str() == want
    assert Tokenizer.from_pretrained(str(snap), device="cpu").to_str() == want
    assert Tokenizer.from_pretrained(str(snap / "tokenizer.json"), device="cpu").to_str() == want
    with pytest.raises(FileNotFoundError):
        Tokenizer.from_pretrained("org/missing", device="cpu")


def test_save_writes_to_str(tmp_path):
    ours = Tokenizer.from_file(_path("sp_bpe"), device="cpu")
    ours.save(str(tmp_path / "a.json"))
    ours.save(str(tmp_path / "b.json"), pretty=False)
    assert open(tmp_path / "a.json", encoding="utf-8").read() == ours.to_str(pretty=True)
    assert open(tmp_path / "b.json", encoding="utf-8").read() == ours.to_str()
