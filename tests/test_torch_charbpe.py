"""The char-level BPE path of the port on the CPU (CharBPE,
SentencePiece BPE, BPE over Whitespace or WhitespaceSplit, the Llama-2
SPM shape), bit-exact (tolerance 0: every value is an id, a position, a
count or a flag).

Tokenizers are trained in-process with the `tokenizers` wheel at a vocab
of 600, as `tests/test_device_charbpe_engine.py` trains them (the
wheel's suffix-BPE trainer differs between processes; in one process
both sides load the same serialization).

* The engine's tables against the JAX engine's arrays: char-id tables,
  `<0xXX>` ids, the merge table's [S, 8] rows, consume-mins, seed, class
  tables.
* `charbpe_program` against the JAX program on seeded [4, 256] byte rows,
  in every kind ("whitespace" with byte fallback, "whitespace_split",
  "bert" with the `</w>` suffix, "metaspace" and "metaspace_pre" with
  `fuse_unk`, "none"), with and without offsets, the merge loop replaced
  by the identity on both sides (so each JAX compile takes about a
  second; `bpe_merge2.run_merge_phases` is held against JAX in
  `tests/test_torch_merge_phases.py`); and once whole, merges included,
  in kind "metaspace" (the one compile of the whole JAX program).
* `Tokenizer(..., device="cpu")` against the wheel on the cases of
  `tests/test_device_charbpe_engine.py` and the CharBPE cases of
  `tests/test_device_offsets.py`, and a Llama-2 SPM case:
  `encode_batch_fast` ids, `encode_batch` ids, char offsets, tokens and
  word ids, and the host pipeline alone.  Without an unk token a dropped
  char shifts the spans after it, as the wheel does (the JAX offsets
  program does not).
* Metaspace pieces: inputs over 16 KB split into pieces of at most 16 KB
  (rows of at most 32,772 positions after the expansion), and an input
  whose pieces would be longer goes to the host.
* The loader's refusals for the shapes it does not honour.
* On a card (`gpu`): the entry points equal their CPU runs.
"""

import json

import jax
import numpy as np
import pytest

import torch
import tokenizers as hf

from tokenizers_tpu.ops import charbpe_encode as jce
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.ops import charbpe_encode as tce
from tokenizers_tpu_torch.ops.charbpe_engine import CharBpeEngine, METASPACE_PIECE
from tokenizers_tpu_torch.ops.engine_base import CHUNK_TARGET

BATCH = [
    "", " ", "Hello world!", "the quick brown fox jumps over the lazy dog",
    "  doubled  spaces  and\ttabs\nnewlines ", "don't you're can't", "café résumé naïve söße",
    "序号123 and 日本語テキスト", "▁literal metaspace char", "punctuation, (lots) of; it!?",
    "zzzzqqqq xjwv unknowable-chars ☃☄", "the the the quick " * 30,
    "x" * 600,  # a word over WORD_CAP: the row goes to the host
]
# tests/test_device_offsets.py's batch
OFFSETS_BATCH = ["Hello world!", "the quick brown fox", "  spaced  out  ", "",
                 "zzz unknownwordzz", "don't stop, won't stop", "Hello WORLD! The Café"]


def corpus_lines(n=4000):
    return [line for line in open("tests/fixtures/corpus.txt", encoding="utf-8")
            .read().split("\n") if line][:n]


def _train(model_kwargs, pre_tok, normalizer=None, special_tokens=("<unk>",), lines=None,
           vocab_size=600):
    rtok = hf.Tokenizer(hf.models.BPE(**model_kwargs))
    if normalizer is not None:
        rtok.normalizer = normalizer
    rtok.pre_tokenizer = pre_tok
    tkw = dict(vocab_size=vocab_size, special_tokens=list(special_tokens), show_progress=False)
    for k in ("end_of_word_suffix", "continuing_subword_prefix"):
        if model_kwargs.get(k):
            tkw[k] = model_kwargs[k]
    rtok.train_from_iterator(corpus_lines() if lines is None else lines,
                             hf.trainers.BpeTrainer(**tkw))
    return rtok.to_str()


def _with_byte_fallback(blob, **edits):
    d = json.loads(blob)
    vocab = d["model"]["vocab"]
    base = max(vocab.values()) + 1
    for bb in range(256):
        vocab.setdefault(f"<0x{bb:02X}>", base + bb)
    d["model"]["byte_fallback"] = True
    d.update(edits)
    return json.dumps(d)


def _spm(blob):
    """The Llama-2 SPM shape of a SentencePiece BPE blob."""
    return _with_byte_fallback(blob, normalizer={"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"},
        {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}, pre_tokenizer=None)


@pytest.fixture(scope="module")
def blobs():
    ws = _train({"unk_token": "<unk>"}, hf.pre_tokenizers.Whitespace())
    sp = _train({"unk_token": "<unk>", "fuse_unk": True}, hf.pre_tokenizers.Metaspace(),
                normalizer=hf.normalizers.NFKC())
    return {
        "ws": ws,
        "ws_fb": _with_byte_fallback(ws),
        "wss": _train({"unk_token": "<unk>"}, hf.pre_tokenizers.WhitespaceSplit()),
        "sp": sp,
        "spm": _spm(sp),
        "char_bpe": _train({"unk_token": "<unk>", "end_of_word_suffix": "</w>"},
                           hf.pre_tokenizers.BertPreTokenizer(),
                           normalizer=hf.normalizers.BertNormalizer(lowercase=False)),
        "no_unk": _train({}, hf.pre_tokenizers.Whitespace(), special_tokens=()),
        "prefix": _train({"unk_token": "<unk>", "continuing_subword_prefix": "##"},
                         hf.pre_tokenizers.Whitespace()),
    }


def _pair(blob):
    ours = Tokenizer.from_str(blob, device="cpu")
    assert isinstance(ours._get_device_engine(), CharBpeEngine)
    return ours, hf.Tokenizer.from_str(blob)


def _check(ours, theirs, batch, offsets=True):
    got = [e.ids for e in ours.encode_batch_fast(list(batch))]
    want = [e.ids for e in theirs.encode_batch_fast(list(batch))]
    for s, g, w in zip(batch, got, want):
        assert g == w, (s[:60], g[:20], w[:20])
    if not offsets:
        return
    ref = theirs.encode_batch(list(batch))
    for run in (ours.encode_batch(list(batch)),
                [ours.encode_host(s, True, offsets="char") for s in batch]):
        for s, o, t in zip(batch, run, ref):
            assert (o.ids, o.offsets, o.tokens, o.word_ids) == (
                t.ids, [tuple(x) for x in t.offsets], t.tokens, t.word_ids), s[:60]


# ------------------------------------------------------------------ tables


def _jax_tables(e) -> dict:
    """The JAX engine's arrays in the port's keys."""
    d = dict(id_s1=e.d_id_s1, id_s2=e.d_id_s2, fb256=e.d_fb256, merge_rows0=e.d_rows0,
             merge_rows1=e.d_rows1, merge_mclr=e.d_mclr, unk_id=e.unk_id, seed=e.seed)
    if e.d_cls_s1 is not None:
        d.update(cls_s1=e.d_cls_s1, cls_s2=e.d_cls_s2)
    return {k: int(v) if k in ("unk_id", "seed") else np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("name", ["ws_fb", "wss", "sp", "spm", "char_bpe", "no_unk", "prefix"])
def test_engine_tables_match_jax(blobs, name):
    want = _jax_tables(JaxTokenizer.from_str(blobs[name])._get_device_engine())
    eng = Tokenizer.from_str(blobs[name], device="cpu")._get_device_engine()
    assert set(eng.tables) == set(want)
    for k, v in want.items():
        got = eng.tables[k]
        if isinstance(v, int):
            assert got == v, k
        else:
            assert got.numpy().dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got.numpy(), v, err_msg=k)


# ----------------------------------------------------------------- program

POOL = ["the", "quick", "fox", "hello", "world", "café", "序号", "123", "it's", "zzzq", "☃☄",
        "naïve", "UPPER", "(lots)", "x" * 30, "résumé", "ﬁle", "don't", "▁lit", "!?"]


def _rows(seed, seps, pool=POOL, B=4, L=256):
    rng = np.random.default_rng(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for r in range(B):
        s = b""
        while True:
            w = (pool[rng.integers(len(pool))] + seps[rng.integers(len(seps))]).encode()
            if len(s) + len(w) > L:
                break
            s += w
        n = 0 if r == 2 else len(s) if r == 0 else int(rng.integers(1, len(s) + 1))
        while 0 < n < len(s) and (s[n] & 0xC0) == 0x80:
            n -= 1
        buf[r, :n] = np.frombuffer(s[:n], np.uint8)
        lens[r] = n
    return buf, lens


# (blob, kind, separators of the seeded rows)
KINDS = {
    "whitespace": ("ws_fb", "whitespace", [" ", "  ", "\t", ""]),
    "whitespace_split": ("wss", "whitespace_split", [" ", "\n", ""]),
    "bert": ("char_bpe", "bert", [" ", "", "  "]),
    "metaspace": ("sp", "metaspace", [" ", "  ", ""]),
    "metaspace_pre": ("sp", "metaspace_pre", ["▁", "▁▁", ""]),
    "none": ("spm", "none", ["▁", ""]),
}


def _programs(blob, kind, buf, lens):
    """(JAX outputs of the offsets form, port outputs with and without
    offsets) on the same rows and the JAX engine's tables."""
    e = JaxTokenizer.from_str(blob)._get_device_engine()
    want = [np.asarray(x) for x in jce.charbpe_program(
        buf, lens, e.d_id_s1, e.d_id_s2, e.d_fb256, e.unk_id, e.d_rows0, e.d_rows1, e.seed,
        e.d_mclr, cls_s1=e.d_cls_s1, cls_s2=e.d_cls_s2, kind=kind,
        byte_fallback=e.byte_fallback, has_unk=e.has_unk, fuse_unk=e.fuse_unk,
        prepend=e.prepend, with_offsets=kind != "metaspace")]
    T = {k: v if isinstance(v, int) else torch.from_numpy(np.array(v))
         for k, v in _jax_tables(e).items()}
    flags = dict(byte_fallback=e.byte_fallback, has_unk=e.has_unk, fuse_unk=e.fuse_unk,
                 prepend=e.prepend)
    if kind == "none":  # the port's merge segments: the same outputs
        flags["meta_seams"] = True
    b, n = torch.from_numpy(buf), torch.from_numpy(lens)
    return (want, tce.charbpe_program(b, n, T, kind=kind, with_offsets=True, **flags),
            tce.charbpe_program(b, n, T, kind=kind, **flags))


def _assert_outputs(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what}: output {k}")


@pytest.mark.parametrize("case", list(KINDS))
def test_program_matches_jax_without_merges(blobs, case, monkeypatch):
    """Seeding, word extents, packing and spans, both variants: the merge
    loop is the identity on both sides (the JAX program's "metaspace" kind
    has no offsets form: its offsets path is "metaspace_pre")."""
    def jax_identity(ids, wid, *_a, obp=None, **_k):
        return ids, wid, jce.jnp.zeros(ids.shape[0], bool), obp

    def identity(ids, wid, *_a, obp=None, **_k):
        return (ids, wid, torch.zeros(ids.shape[0], dtype=torch.bool)) + (
            () if obp is None else (obp,))

    monkeypatch.setattr(jce, "run_merge_phases", jax_identity)
    monkeypatch.setattr(tce, "run_merge_phases", identity)
    name, kind, seps = KINDS[case]
    jax.clear_caches()  # the jitted program must trace the identity, not reuse a trace
    try:
        for seed in range(2):
            buf, lens = _rows(seed, seps)
            want, got, plain = _programs(blobs[name], kind, buf, lens)
            if kind != "metaspace":
                _assert_outputs(got, want, f"{case} offsets, seed {seed}")
            _assert_outputs(plain, want[:3], f"{case}, seed {seed}")
    finally:
        jax.clear_caches()


def test_program_matches_jax_metaspace(blobs):
    """The whole program, merges included: the Metaspace expansion to
    [4, 516], fused unk runs, and the merge phases."""
    buf, lens = _rows(7, [" ", "  ", ""])
    jax.clear_caches()
    want, _got, plain = _programs(blobs["sp"], "metaspace", buf, lens)
    _assert_outputs(plain, want, "metaspace")
    assert int(np.asarray(want[1]).sum()) > 0


def test_meta_seams_change_no_output(blobs):
    """Kind "none": merging each run between `▁` seams on its own gives
    the row-whole merge's outputs, offsets included, in fewer rounds."""
    eng = Tokenizer.from_str(blobs["spm"], device="cpu")._get_device_engine()
    assert eng.flags["meta_seams"]
    flags = {k: v for k, v in eng.flags.items() if k != "meta_seams"}
    buf, lens = _rows(3, ["▁", ""])
    b, n = torch.from_numpy(buf), torch.from_numpy(lens)
    whole = tce.charbpe_program(b, n, eng.tables, kind="none", with_offsets=True, **flags)
    seams = tce.charbpe_program(b, n, eng.tables, kind="none", with_offsets=True,
                                meta_seams=True, **flags)
    ok = ~whole[2]  # a flagged row's contents are not compared (the host re-encodes it)
    assert torch.equal(seams[2], whole[2]) and int(ok.sum()) >= 2
    for k, (x, y) in enumerate(zip(seams, whole)):
        assert torch.equal(x[ok], y[ok]), k


# ------------------------------------------------------------ against wheel


@pytest.mark.parametrize("name", ["ws", "wss", "sp", "char_bpe", "no_unk", "ws_fb", "prefix",
                                  "spm"])
def test_matches_wheel(blobs, name):
    _check(*_pair(blobs[name]), BATCH)


@pytest.mark.parametrize("scheme", ["always", "first", "never"])
def test_added_tokens_route_host(blobs, scheme):
    """Inputs holding an added token take the host pipeline: Metaspace
    prepends to each piece between added tokens ("always"), to the text's
    first piece only ("first") or to none ("never")."""
    blob = _edited(blobs["sp"], ("pre_tokenizer", "prepend_scheme"), scheme)
    ours, theirs = _pair(blob)
    _check(ours, theirs, ["hello<unk>world", "<unk> the fox <unk>", " lead<unk> x", "plain"])


def test_corpus_and_repetitive(blobs):
    _check(*_pair(blobs["sp"]), corpus_lines(300), offsets=False)
    lines = corpus_lines(50)
    _check(*_pair(blobs["ws"]), lines * 3 + ["many words repeat " * 40], offsets=False)


@pytest.mark.parametrize("metaspace,suffix,lowercase", [(False, "</w>", True), (True, "", False)])
def test_offsets_cases_of_the_jax_suite(metaspace, suffix, lowercase):
    """`tests/test_device_offsets.py::test_charbpe_offsets`: every input on
    the device (the host path is not called)."""
    corpus = open("tests/fixtures/corpus.txt", encoding="utf-8").read()[:150_000].splitlines()
    ref = hf.Tokenizer(hf.models.BPE(end_of_word_suffix=suffix, unk_token="<unk>"))
    ref.pre_tokenizer = (hf.pre_tokenizers.Metaspace() if metaspace
                         else hf.pre_tokenizers.Whitespace())
    if lowercase:
        ref.normalizer = hf.normalizers.Lowercase()
    ref.train_from_iterator(corpus, hf.trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<unk>"], end_of_word_suffix=suffix,
        show_progress=False))
    ours, theirs = _pair(ref.to_str())

    def boom(*a, **k):
        raise AssertionError("host fallback used")

    ours.encode_host = boom
    for s, o, t in zip(OFFSETS_BATCH, ours.encode_batch(OFFSETS_BATCH),
                       theirs.encode_batch(OFFSETS_BATCH)):
        assert (o.ids, o.offsets, o.tokens, o.word_ids) == (
            t.ids, [tuple(x) for x in t.offsets], t.tokens, t.word_ids), s


def test_metaspace_pieces(blobs, monkeypatch):
    """Inputs over 16 KB: pieces of at most 16 KB on the ids path, so no
    row of the merge loop is wider than 32,772; an input without such
    pieces goes to the host; the offsets path keeps MAX_L // 2."""
    ours, theirs = _pair(blobs["sp"])
    eng = ours._get_device_engine()
    widths = []
    program = tce.charbpe_program
    monkeypatch.setattr("tokenizers_tpu_torch.ops.charbpe_engine.charbpe_program",
                        lambda b, *a, **k: widths.append(b.shape[1]) or program(b, *a, **k))
    text = " ".join(corpus_lines(2000))
    long_doc = text[:40_000]
    no_seam = "a " * 100 + "b" * 20_000 + " c"
    assert eng._pieces(long_doc.encode(), False) is not None
    assert eng._pieces(no_seam.encode(), False) is None
    assert eng._pieces(no_seam.encode(), True) == [no_seam.encode()]
    _check(ours, theirs, [long_doc, no_seam, "short one"], offsets=False)
    assert widths and max(widths) <= METASPACE_PIECE < CHUNK_TARGET
    assert 2 * max(widths) + 4 <= 32_772


def test_encode_batch_arrays(blobs):
    ours, theirs = _pair(blobs["sp"])
    batch = BATCH[:6] + ["x" * 600]
    want = [e.ids for e in theirs.encode_batch_fast(batch)]
    seen = set()
    for ids, ntok, bad, owners in ours.encode_batch_arrays(batch):
        for r, (i, _k) in enumerate(owners):
            if not bool(bad[r]):
                assert ids[r, : int(ntok[r])].tolist() == want[i], batch[i]
                seen.add(i)
    assert seen == set(range(6))  # the word over WORD_CAP is flagged


def _edited(blob, path, value):
    d = json.loads(blob)
    node = d
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return json.dumps(d)


@pytest.mark.parametrize("path,value", [
    (("model", "dropout"), 0.1),
    (("model", "ignore_merges"), True),
    (("pre_tokenizer", "replacement"), "_"),
    (("pre_tokenizer", "split"), False),
    (("pre_tokenizer",), {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}),
    (("pre_tokenizer",), {"type": "Punctuation", "behavior": "Isolated"}),
    (("normalizer",), {"type": "Replace", "pattern": {"Regex": " +"}, "content": "▁"}),
    (("normalizer",), {"type": "Nmt"}),
    (("normalizer",), {"type": "Precompiled", "precompiled_charsmap": ""}),
    (("model", "type"), "WordLevel"),
])
def test_loader_refuses_what_it_does_not_honour(blobs, path, value):
    """Once refused, now loaded as the JAX package loads it (the general
    host pipeline where no engine takes it): encoded as the wheel does,
    under dropout as JAX does with the same seed; the empty Precompiled
    charsmap is refused, as JAX and the wheel refuse it
    (`torch_reference.loads_as_the_reference`)."""
    from torch_reference import loads_as_the_reference

    loads_as_the_reference(_edited(blobs["sp"], path, value))


def _same_as_wheel(blob, texts):
    """The port loads `blob` and encodes `texts` as the wheel does (ids,
    tokens, type ids, offsets, masks)."""
    ours = Tokenizer.from_str(blob, device="cpu")
    ref = hf.Tokenizer.from_str(blob)
    for g, w in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
        assert (g.ids, g.tokens, g.type_ids, g.offsets, g.attention_mask) == (
            w.ids, w.tokens, w.type_ids, [tuple(o) for o in w.offsets], w.attention_mask), g.ids


@pytest.mark.parametrize("path,value", [
    (("post_processor",), {"type": "ByteLevel", "add_prefix_space": True,
                           "trim_offsets": True, "use_regex": True}),
    (("added_tokens", 0, "normalized"), True),
])
def test_loader_admits_what_it_now_honours(blobs, path, value):
    """A ByteLevel post-processor behind Metaspace and an added token
    matched on the normalized text (refused before the Tokenizer's full
    surface was ported)."""
    _same_as_wheel(_edited(blobs["sp"], path, value),
                   ["Hello world! <unk>a", "x  y\tz ＡＢＣ<unk>", "naïve café 12", ""])


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["char_bpe", "sp_bpe", "spm_bf"])
def test_gpu_matches_cpu(config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tokenizers_tpu_torch.smoke_data import build_docs, config_json

    docs = build_docs()[:40] + BATCH
    cpu = Tokenizer.from_str(config_json(config), device="cpu")
    gpu = Tokenizer.from_str(config_json(config))
    assert isinstance(gpu._get_device_engine(), CharBpeEngine)
    assert [e.ids for e in gpu.encode_batch_fast(docs)] == \
        [e.ids for e in cpu.encode_batch_fast(docs)]
    for g, c in zip(gpu.encode_batch(docs), cpu.encode_batch(docs)):
        assert (g.ids, g.offsets, g.word_ids) == (c.ids, c.offsets, c.word_ids)
