"""The slice end to end on the CPU.

* The port's `encode_program_scan` against the JAX program at
  [2, 16, 256] (the one whole-program JAX compile of the port's tests),
  with the engine's gpt2 tables carried across by `tables_from_numpy`:
  ids, ntok, row_bad and the word-cache state after every call, over
  chunks whose words repeat earlier ones (cache hits), a chunk that
  overflows the dedup buffer into the big-bucket branch (forced at this
  size by TOKENIZERS_TPU_BIG_BUCKET_MIN) and the epoch reset.
* `Tokenizer.from_file(gpt2, device="cpu").encode_batch_fast` against the
  `tokenizers` wheel on the corpus documents of chip_smoke.py and on
  probes: added tokens, empty strings and batches, inputs over 64 KB with
  and without safe seams, CJK and other multi-byte text, contractions.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.ops.bpe_encode import encode_program_scan as jax_scan
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer, pick_device
from tokenizers_tpu_torch.ops import engine_base
from tokenizers_tpu_torch.ops.bpe_dedup import WordCache
from tokenizers_tpu_torch.ops.bpe_encode import encode_program_scan
from tokenizers_tpu_torch.ops.bpe_engine import tables_from_numpy
from tokenizers_tpu_torch.smoke_data import build_docs

GPT2 = "tests/fixtures/gpt2/tokenizer.json"
N, B, L = 2, 16, 256
SC, CAP = 1 << 10, 2350  # small enough that the fifth chunk resets the epoch


def _chunk(kind, seed):
    """[B, L] ASCII rows.  `prose`: corpus words, 60 drawn per chunk from a
    pool of 150, so the chunk fits the dedup buffer and chunks share
    words; `random`: distinct random words, so the buffer overflows."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lens[3] = 0
    if kind == "prose":
        words = open("tests/fixtures/corpus.txt", "rb").read()[:20_000].split()
        pool = sorted({w for w in words if max(w) < 128})[:150]
        pick = [pool[i] for i in np.random.default_rng(seed).choice(150, 60, replace=False)]
        rows = [b" ".join(pick[i] for i in rng.integers(0, 60, L)) for _ in range(B)]
    else:
        rows = [bytes(rng.integers(33, 127, L, dtype=np.uint8)) for _ in range(B)]
    for r, row in enumerate(rows):
        buf[r, : lens[r]] = np.frombuffer(row[: lens[r]], np.uint8)
    return buf, lens


def test_encode_program_scan_matches_jax(monkeypatch):
    monkeypatch.setenv("TOKENIZERS_TPU_BIG_BUCKET_MIN", str(B * L))
    args = JaxTokenizer.from_file(GPT2)._get_device_engine()._program_args()
    tables = tables_from_numpy({k: np.asarray(v) for k, v in args.items()
                                if k in ("byte2id", "cls_table", "merge_rows0",
                                         "merge_rows1", "merge_mclr", "seed")}, "cpu")
    cache = WordCache(SC, CAP, "cpu")
    j_state = (jnp.zeros((SC, 4), jnp.int32), jnp.full((CAP + 1,), -1, jnp.int32),
               jnp.int32(0))
    calls = [(("prose", 1), ("prose", 2)), (("random", 3), ("prose", 4)),
             (("prose", 5), ("prose", 1))]
    seen = {"reset": False, "host": False}
    for call in calls:
        bufs, lens = map(np.stack, zip(*(_chunk(*c) for c in call)))
        p_before = cache.p
        ids, ntok, bad = encode_program_scan(torch.from_numpy(bufs), torch.from_numpy(lens),
                                             tables, cache=cache, ascii_only=True)
        j_ids, j_ntok, j_bad, j_state = jax_scan(
            jnp.asarray(bufs), jnp.asarray(lens), cache_rows=j_state[0],
            cache_buf=j_state[1], cache_p=j_state[2], ascii_only=True, **args)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(ntok.numpy(), np.asarray(j_ntok))
        np.testing.assert_array_equal(bad.numpy(), np.asarray(j_bad))
        np.testing.assert_array_equal(cache.rows.numpy(), np.asarray(j_state[0]))
        np.testing.assert_array_equal(cache.buf.numpy(), np.asarray(j_state[1]))
        assert cache.p == int(j_state[2])
        seen["reset"] |= cache.p < p_before
        seen["host"] |= bool(bad.all(1).any())
    assert all(seen.values()), seen


def _probes():
    return [
        "Hello world!", "don't stop", "序号123 漢字かな ΑΒΓ", "a<|endoftext|>b",
        "<|endoftext|>", "", "  x", "y'all'll've", "naïve café　end\xa0x",
        "emoji 🙂🙂 ok's 42½", "\t\n  spaces   \r\n",
        "word " * 14_000,  # > 64 KB: split at safe seams onto the device
        "x" * 140_000,  # > 64 KB with no seam: the host path
        "".join(chr(0x4E00 + i % 2000) for i in range(3000)),
    ]


@pytest.fixture(scope="module")
def pair():
    return Tokenizer.from_file(GPT2, device="cpu"), WheelTokenizer.from_file(GPT2)


@pytest.mark.parametrize("batch", ["probes", "empty", "corpus", "random_words"])
def test_encode_batch_fast_matches_wheel(pair, batch):
    tok, wheel = pair
    if batch == "probes":
        inputs = _probes()
    elif batch == "empty":
        inputs = []
    elif batch == "corpus":
        inputs = build_docs()
    else:  # small chunks whose words overflow the dedup buffer: full width
        rng = np.random.default_rng(9)
        inputs = [" ".join(bytes(rng.integers(97, 123, int(rng.integers(3, 12)),
                                              dtype=np.uint8)).decode()
                           for _ in range(300)) for _ in range(24)]
    engine_base.STATS.reset()
    got = [e.ids for e in tok.encode_batch_fast(inputs)]
    want = [e.ids for e in wheel.encode_batch_fast(inputs, add_special_tokens=True)]
    assert got == want
    snap = engine_base.STATS.snapshot()
    if batch == "probes":
        assert snap["host_pre_inputs"] == 3  # two added-token inputs, one seamless
    if batch == "corpus":
        assert snap["device_rows"] == len(inputs)


def test_encode_fast_and_the_device_pick(pair):
    tok, wheel = pair
    assert tok.encode_fast("y'all'll've").ids == wheel.encode("y'all'll've").ids
    if torch.cuda.is_available():
        assert pick_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Tokenizer.from_file(GPT2)


def _edited(path, value):
    import json

    d = json.load(open(GPT2, encoding="utf-8"))
    node = d
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return json.dumps(d)


@pytest.mark.parametrize("path,value", [
    (("normalizer",), {"type": "NFC"}),
    (("pre_tokenizer", "use_regex"), False),
    (("model", "ignore_merges"), True),
    (("model", "byte_fallback"), True),
    (("model", "continuing_subword_prefix"), "##"),
    (("model", "dropout"), 0.1),
])
def test_loader_refuses_what_it_does_not_honour(path, value):
    """Once refused, now loaded as the JAX package loads it (the general
    host pipeline where no engine takes it): encoded as the wheel does,
    under dropout as JAX does with the same seed
    (`torch_reference.loads_as_the_reference`)."""
    from torch_reference import loads_as_the_reference

    loads_as_the_reference(_edited(path, value))


def _same_as_wheel(blob, texts):
    """The port loads `blob` and encodes `texts` as the wheel does (ids,
    tokens, type ids, offsets, masks)."""
    ours = Tokenizer.from_str(blob, device="cpu")
    ref = WheelTokenizer.from_str(blob)
    for g, w in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
        assert (g.ids, g.tokens, g.type_ids, g.offsets, g.attention_mask) == (
            w.ids, w.tokens, w.type_ids, [tuple(o) for o in w.offsets], w.attention_mask), g.ids


@pytest.mark.parametrize("path,value", [
    (("post_processor",), {"type": "TemplateProcessing", "single": [], "pair": [],
                           "special_tokens": {}}),
    (("truncation",), {"direction": "Right", "max_length": 8, "strategy": "LongestFirst",
                       "stride": 0}),
    (("added_tokens", 0, "lstrip"), True),
    (("added_tokens", 0, "special"), False),
    (("pre_tokenizer",), {"type": "Whitespace"}),
])
def test_loader_admits_what_it_now_honours(path, value):
    """Post-processors, truncation and added-token options, and a BPE
    over Whitespace beside the fixture's added token matched on the
    normalized text (refused before the Tokenizer's full surface was
    ported)."""
    _same_as_wheel(_edited(path, value), ["Hello world! <|endoftext|>a", "x  y\tz", "naïve café 12", ""])


@pytest.mark.gpu
def test_gpu_encode_batch_fast_matches_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tok_cpu, wheel = pair
    docs = build_docs()[:40] + _probes()
    want = [e.ids for e in wheel.encode_batch_fast(docs, add_special_tokens=True)]
    tok = Tokenizer.from_file(GPT2)
    assert tok.device.type == "cuda"
    assert [e.ids for e in tok.encode_batch_fast(docs)] == want
    assert [e.ids for e in tok_cpu.encode_batch_fast(docs)] == want
