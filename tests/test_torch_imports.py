"""The port stands alone: importing it, running one encode and training
loads no module of JAX, `regex`, the `tokenizers` wheel or
`tokenizers_tpu` (with and without offsets, the host path included, for
the gpt2, llama3, bert, WordLevel, char-level BPE and Unigram pipelines;
BPE training on the dense and the per-round path, WordPiece, WordLevel
and Unigram training, `Tokenizer.train_from_iterator`, `decode` and
`decode_stream`; a process group of one rank through the sharded encode,
both trainers' mesh arguments and `entry`; the five recipes trained, with
added tokens, truncation, padding, pairs, pre-tokenized input, a
post-processor, `to_str`, `from_str` and pickling; the patterns, the
general host pipeline on every pipeline of `smoke_data.host_pipelines`,
UnicodeScripts, the ByteLevel normalizer and a regex Replace decoder;
`Precompiled` and the grapheme segmentation, the host pool, the
visualizer), and no source file of the package imports them.  The C ABI
(`native/c_api.cpp`) imports no module of Python but the port's and
`json`."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "regex", "tokenizers", "tokenizers_tpu")

_PROBE = """
import json
import sys
from tokenizers_tpu_torch import Tokenizer
tok = Tokenizer.from_file("tests/fixtures/gpt2/tokenizer.json", device="cpu")
ids = [e.ids for e in tok.encode_batch_fast(["Hello world! y'all'll've", "序号123", "a<|endoftext|>b"])]
assert ids[2] == [65, 0, 66], ids
encs = tok.encode_batch(["Hello world!", "a<|endoftext|>b", "x" * 600])
assert encs[0].offsets == [(0, 5), (6, 11), (11, 12)] and encs[1].word_ids == [0, 1, 2], encs
tok = Tokenizer.from_file("tests/fixtures/llama3/tokenizer.json", device="cpu")
ids = [e.ids for e in tok.encode_batch_fast(["Hello world! Don'ſ 12345\\r\\n", "a<|end_of_text|>b"])]
assert ids[0][0] == 0 and ids[1] == [0, 66, 1, 67], ids
tok = Tokenizer.from_file("tests/fixtures/bert/tokenizer.json", device="cpu")
assert type(tok._get_device_engine()).__name__ == "WordPieceEngine"
ids = [e.ids for e in tok.encode_batch_fast(["Hello, World! café 中文", "a[SEP]b", "x" * 600])]
assert ids[1] == [2, 43, 3, 44, 3], ids
encs = tok.encode_batch(["Hello, World! café", "a[SEP]b"])
assert encs[0].offsets[1:3] == [(0, 5), (5, 6)] and encs[1].word_ids == [None, 0, 1, 2, None], encs
from tokenizers_tpu_torch.smoke_data import config_json
for name, engine in (("wordlevel", "WordLevelEngine"), ("char_bpe", "CharBpeEngine"),
                     ("sp_bpe", "CharBpeEngine"), ("spm_bf", "CharBpeEngine")):
    tok = Tokenizer.from_str(config_json(name), device="cpu")
    assert type(tok._get_device_engine()).__name__ == engine, name
    texts = ["Hello world! café ﬁle", "naïve 序号 x", "x<unk>y [UNK]"]
    fast = [e.ids for e in tok.encode_batch_fast(texts)]
    encs = tok.encode_batch(texts)
    assert [e.ids for e in encs] == fast and all(fast), (name, fast)
    assert encs[0].offsets[-1][1] == len(texts[0].rstrip()), (name, encs[0].offsets)
for name in ("unigram", "unigram_bf"):
    tok = Tokenizer.from_str(config_json(name), device="cpu")
    assert type(tok._get_device_engine()).__name__ == "UnigramEngine", name
    texts = ["Hello  world!\t café ☃ 'Ve'll....", "日本語 x" * 3, "x<unk>y", "x" * 200]
    fast = [e.ids for e in tok.encode_batch_fast(texts)]
    encs = tok.encode_batch(texts)
    assert [e.ids for e in encs] == fast and all(fast), (name, fast)
    assert encs[2].ids[1] == 0 and encs[0].offsets[-1][1] == len(texts[0]), (name, encs[0].offsets)
from tokenizers_tpu_torch.models.bpe import BPE
from tokenizers_tpu_torch.models.wordpiece import WordPiece
from tokenizers_tpu_torch.parallel import DistributedBpeTrainer
from tokenizers_tpu_torch.parallel.bpe_train import train_per_round
from tokenizers_tpu_torch.smoke_data import recipe_json
from tokenizers_tpu_torch.trainers import BpeTrainer, WordLevelTrainer, WordPieceTrainer
lines = ["low lower lowest newer newest wider\\n", "the quick brown fox jumps over the lazy dog\\n",
         "aaaa abab ababab hugging face tokenizers\\n"] * 3
tok = Tokenizer.from_str(recipe_json("sp_bpe"), device="cpu")
trainer = BpeTrainer(vocab_size=60, special_tokens=["<unk>"], device="cpu")
tok.train_from_iterator(lines, trainer)
assert trainer.stats["path"] == "dense" and tok.added == {"<unk>": 0}, (trainer.stats, tok.added)
ids = tok.encode_batch_fast(["the lowest tokenizers"])[0].ids
assert ids and all(i < 60 for i in ids), ids
cfg = BpeTrainer(vocab_size=60, special_tokens=["<unk>"], device="cpu")
w2i, i2w, words, counts = cfg.prepare(trainer.words)
merges = train_per_round(cfg, w2i, i2w, words, counts, "cpu")
assert [(i2w[a], i2w[b]) for (a, b), _ in merges] == tok.model.merges_list, merges
dev = DistributedBpeTrainer(device="cpu", vocab_size=60, continuing_subword_prefix="##")
dev.feed(lines, str.split)
dev.train(BPE({}, []))
wp = WordPieceTrainer(vocab_size=60, device="cpu")
wp.feed(lines, str.split)
model = WordPiece({})
wp.train(model)
assert "##s" in model.vocab and wp.stats["path"] == "dense", model.vocab
tok = Tokenizer.from_str(recipe_json("wordlevel"), device="cpu")
tok.train_from_iterator(lines, WordLevelTrainer(special_tokens=["[UNK]"]))
assert tok.encode_batch_fast(["the fox zzz"])[0].ids == [1, 8, 0], tok.model.vocab
from tokenizers_tpu_torch.trainers import UnigramTrainer
tok = Tokenizer.from_str(recipe_json("unigram"), device="cpu")
trainer = UnigramTrainer(vocab_size=40, special_tokens=["<unk>"], unk_token="<unk>", device="cpu")
tok.train_from_iterator(lines, trainer)
assert trainer.stats["path"] == "device" and tok.added == {"<unk>": 0}, trainer.stats
ids = tok.encode_batch_fast(["the lowest tokenizers"])[0].ids
assert tok.decode(ids) == "the lowest tokenizers", (ids, tok.decode(ids))
for name in ("gpt2", "bert", "spm_bf", "unigram_bf"):
    tok = Tokenizer.from_str(config_json(name), device="cpu")
    ids = tok.encode_batch_fast(["Hello world ☃"])[0].ids
    stream = tok.decode_stream()
    assert "".join(x for x in map(stream.step, ids) if x) == tok.decode(ids), name
import tempfile
from tokenizers_tpu_torch import entry
from tokenizers_tpu_torch.models.unigram import Unigram
from tokenizers_tpu_torch.parallel import runtime, shard_encode_batch
assert runtime.initialize() is False
runtime.initialize("file://" + tempfile.mkdtemp() + "/store", 1, 0, device="cpu")
mesh = runtime.build_mesh(("hosts", "data"))
tok = Tokenizer.from_file("tests/fixtures/gpt2/tokenizer.json", device="cpu")
got = shard_encode_batch(tok._get_device_engine(), ["Hello world!"], mesh)
assert got == [tok.encode_host("Hello world!").ids], got
model = BPE({}, [])
DistributedBpeTrainer(mesh=mesh, device="cpu", vocab_size=60).do_train({"low": 3, "newest": 4}, model)
assert model.merges_list, model.merges_list
trainer = UnigramTrainer(vocab_size=12, special_tokens=["<unk>"], unk_token="<unk>",
                         device="cpu", mesh=mesh)
trainer.words = {"abc": 2, "abd": 1, "bcd": 1, "abcd": 1}
trainer.train(Unigram([("<unk>", 0.0)], unk_id=0))
fn, args = entry.entry("cpu")
assert fn(*args)[0].shape == (2, 64)
runtime.shutdown()
import pickle
from tokenizers_tpu_torch import implementations as recipes
from tokenizers_tpu_torch.added_vocabulary import AddedToken
from tokenizers_tpu_torch.processors import RobertaProcessing
bl = recipes.ByteLevelBPETokenizer(device="cpu")
bl.train_from_iterator(lines, vocab_size=280, special_tokens=["<|endoftext|>"])
bl.add_tokens([AddedToken("zz", lstrip=True, rstrip=True, single_word=True)])
bl.enable_truncation(6, stride=1)
bl.enable_padding(pad_to_multiple_of=8)
encs = bl.encode_batch_fast(["the lowest tokenizers zz", "a<|endoftext|>b"])
assert [len(e.ids) for e in encs] == [8, 8] and encs[0].overflowing, encs
assert len(bl.encode("the fox", "the dog").ids) == 8
tok = Tokenizer.from_str(bl.to_str(), device="cpu")
assert pickle.loads(pickle.dumps(tok)).to_str() == bl.to_str()
tok.post_processor = RobertaProcessing(("</s>", 2), ("<s>", 1))
assert tok.encode(["the", "fox"], is_pretokenized=True).ids[0] == 1
for name, kw in (("CharBPETokenizer", {}), ("SentencePieceBPETokenizer", {}),
                 ("BertWordPieceTokenizer", {}),
                 ("SentencePieceUnigramTokenizer", {"special_tokens": ["<unk>"],
                                                    "unk_token": "<unk>"})):
    r = getattr(recipes, name)(device="cpu")
    r.train_from_iterator(lines, vocab_size=80, **kw)
    assert r.encode_batch(["the lowest", ("the", "fox")])[1].ids, name
    back = Tokenizer.from_str(r.to_str(), device="cpu").to_str()
    # Unigram scores read back as the wheel reads them (serde_f64): not the same bits
    assert back == r.to_str() or "Unigram" in name, name
from tokenizers_tpu_torch import pre_tokenizers as P
from tokenizers_tpu_torch.decoders import Replace as ReplaceDecoder
from tokenizers_tpu_torch.normalizers import ByteLevel as ByteLevelNormalizer
from tokenizers_tpu_torch.pattern import SysRegex, find_matches
from tokenizers_tpu_torch.smoke_data import host_pipelines
assert find_matches(SysRegex(r"\\p{L}+"), "ab 12") == [((0, 2), True), ((2, 5), False)]
assert P.UnicodeScripts().pre_tokenize_str("abc日本") == [("abc", (0, 3)), ("日本", (3, 5))]
assert ByteLevelNormalizer().normalize_str(" é") == "ĠÃ©"
assert ReplaceDecoder(r"\\s+", "_", regex=True).decode(["a  b"]) == "a_b"
for name, blob in host_pipelines().items():
    tok = Tokenizer.from_str(blob, device="cpu")
    encs = tok.encode_batch(["Hello World! 2024 x²y 日本語", "a"])
    assert encs[0].ids == tok.encode_batch_fast(["Hello World! 2024 x²y 日本語"])[0].ids, name
    assert Tokenizer.from_str(tok.to_str(), device="cpu").to_str() == tok.to_str(), name
from tokenizers_tpu_torch.graphemes import graphemes
from tokenizers_tpu_torch.normalizers.precompiled import CHARSMAP_NFKC_PATH, Precompiled
from tokenizers_tpu_torch.tools import EncodingVisualizer
from tokenizers_tpu_torch.utils.parallelism import maybe_par_map
assert graphemes("क्षa\U0001f44d\u200d\U0001f44d") == ["क्ष", "a", "\U0001f44d\u200d\U0001f44d"]
assert Precompiled(open(CHARSMAP_NFKC_PATH, "rb").read()).normalize_str("ＡＢ①") == "AB1"
assert "token" in EncodingVisualizer(tok)("Hello")
assert maybe_par_map(abs, range(-8, 8)) == [abs(x) for x in range(-8, 8)]
import tokenizers_tpu_torch as tt
from tokenizers_tpu_torch.serialization import model_from_dict, tokenizer_from_dict
from tokenizers_tpu_torch.utils.unicode_norm import nfkc_transform
previous = tt.set_default_device("cpu")
tok = tt.Tokenizer(tt.models.BPE(unk_token=None))
tok.pre_tokenizer, tok.decoder = tt.pre_tokenizers.ByteLevel(), tt.decoders.ByteLevel()
tok.train_from_iterator(lines, tt.trainers.BpeTrainer(
    vocab_size=280, special_tokens=[tt.AddedToken("<|endoftext|>", special=True)]))
ids = tok.encode_batch_fast(["the lowest<|endoftext|>"])[0].ids
assert tok.decode(ids) == " the lowest" and tok.device.type == "cpu", ids
words = [t.value for t in tok.model.tokenize("Ġlowest")]
assert "".join(words) == "Ġlowest" and isinstance(tok.model, tt.models.Model), words
assert tokenizer_from_dict(json.loads(tok.to_str())).to_str() == tok.to_str()
wl = model_from_dict({"type": "WordLevel", "vocab": {"a": 0}, "unk_token": "a"})
assert wl.tokenize("b")[0].id == 0
assert tt.normalizers.BertNormalizer().normalize_str("Héllo") == "hello"
assert tt.pre_tokenizers.PreTokenizedString("a b").get_splits()
assert nfkc_transform("ﬁ")[0] == [("f", 0), ("i", 1)]
assert tt.set_default_device(previous).type == "cpu"
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_encode_loads_no_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


@pytest.mark.parametrize("top", ["tokenizers_tpu_torch", "chip_smoke.py"])
def test_no_source_imports_them(top):
    pat = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.M)
    path = os.path.join(REPO, top)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs if f.endswith(".py")]
    assert files
    for f in files:
        with open(f, encoding="utf-8") as fh:
            assert not pat.search(fh.read()), f


def test_c_api_embeds_only_the_port():
    with open(os.path.join(REPO, "tokenizers_tpu_torch", "native", "c_api.cpp"),
              encoding="utf-8") as f:
        src = f.read()
    imported = set(re.findall(r'PyImport_ImportModule\(\s*"([^"]+)"', src))
    assert imported == {"tokenizers_tpu_torch", "tokenizers_tpu_torch.serialization", "json"}
    assert not re.search(r"tokenizers_tpu(?!_torch)|jax|JAX_PLATFORMS|\bregex\b", src.replace(
        "the JAX package", ""))
    assert not re.search(r"^\s*import\b|\bimport (?!sys\\n)", " ".join(
        re.findall(r'PyRun_SimpleString\(((?:\s*"[^"]*")+)', src)))
