"""Unigram EM training of the torch port against the JAX package and the
wheel, step by step (JAX's trainer is never run end to end: it takes
minutes here).

* The lattice (`viterbi`, `nbest(2)`, `populate_marginal`) and
  `Unigram.populate_nodes` equal JAX's exactly, on the JAX tests' toy
  model and on 300 corpus words with the `unigram` fixture's vocab.
* The seed enumerator (`native.suffix_substrings`, C++) equals its numpy
  version and JAX's.
* `PieceTable` equals JAX's slot for slot, its None cases included.
* `em_marginal_program` and `viterbi_freq_program` equal JAX's (CPU,
  x64): expected counts and z within 1e-12 relative, ntok and
  frequencies exact; `DeviceEm` equals the host lattices with a sentence
  over 512 bytes (the host route) and a multi-byte char (an unk node),
  and two E-steps are bit-equal.
* Seeding, the M-step, one pruning round and finalize equal JAX's host
  route (forced on the JAX side with its own switch).
* Training on the device route (`device="cpu"`) equals the port's host
  oracle, and the wheel at vocab 100 on 250 corpus lines.
* On a card (`gpu`): `DeviceEm` equals its CPU run.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tokenizers import Tokenizer as WheelTokenizer
from tokenizers import models as wmodels
from tokenizers import pre_tokenizers as wpre
from tokenizers import trainers as wtrainers

from tokenizers_tpu import native as jnative
from tokenizers_tpu.models.unigram import Unigram as JaxUnigram
from tokenizers_tpu.models.unigram_lattice import Lattice as JaxLattice
from tokenizers_tpu.ops import unigram_em_step as jem
from tokenizers_tpu.trainers import unigram_em as jtr
from tokenizers_tpu.trainers.unigram_trainer import UnigramTrainer as JaxUnigramTrainer
from tokenizers_tpu_torch import native
from tokenizers_tpu_torch.models.unigram import Unigram
from tokenizers_tpu_torch.models.unigram_lattice import Lattice
from tokenizers_tpu_torch.ops import unigram_em_step as tem
from tokenizers_tpu_torch.pre_tokenizers.whitespace import WhitespaceSplit
from tokenizers_tpu_torch.smoke_data import CORPUS, UNIGRAM_CONFIGS
from tokenizers_tpu_torch.trainers import UnigramTrainer
from tokenizers_tpu_torch.trainers import unigram_em as ttr
from tokenizers_tpu_torch.utils.serde_float import serde_f64

SENTENCES = [("hello", 5), ("world", 3), ("hell", 2), ("low", 7), ("lower", 1),
             ("héllo", 2), ("owo", 4), ("wow", 1)]
PIECES = [("h", -2.0), ("e", -2.5), ("l", -1.5), ("o", -2.2), ("w", -3.0), ("r", -3.1),
          ("he", -3.3), ("ll", -2.9), ("lo", -3.6), ("low", -4.0), ("hello", -6.0),
          ("wo", -3.8)]
TOY = [("<unk>", 0.0)] + PIECES
LONG = ("lowhello" * 70 + "héllo", 3)  # 566 bytes: the host route


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the DP loops run many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus_lines(n):
    with open(CORPUS, encoding="utf-8") as f:
        return [line for line in f.read().split("\n") if line][:n]


@pytest.fixture(scope="module")
def fixture_vocab():
    with open(UNIGRAM_CONFIGS["unigram"], encoding="utf-8") as f:
        m = json.loads(f.read(), parse_float=serde_f64)["model"]
    return [(t, s) for t, s in m["vocab"]], m["unk_id"]


def _corpus_words(n=300):
    seen = {}
    for line in _corpus_lines(2000):
        for w in line.split():
            seen.setdefault("▁" + w, None)
            if len(seen) == n:
                return list(seen)
    return list(seen)


def _nodes(lat):
    return [[(n.pos, n.length, n.id, n.score) for n in b] for b in lat.begin_nodes]


def _host(model, sentences):
    """(expected, z, ntok, freq) of the port's host lattices."""
    expected, freq, z, ntok = [0.0] * len(model.pieces), [0.0] * len(model.pieces), [], 0
    for s, n in sentences:
        lat = Lattice(s, model.bos_id, model.eos_id)
        model.populate_nodes(lat)
        z.append(lat.populate_marginal(float(n), expected))
        path = lat.viterbi()
        ntok += len(path)
        for node in path:
            freq[node.id] += float(n)
    return np.array(expected), np.array(z), ntok, np.array(freq)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300), initial=0.0))


# ---------------------------------------------------------------- lattice


@pytest.mark.parametrize("case", ["toy", "corpus_words"])
def test_lattice_equals_jax(case, fixture_vocab):
    if case == "toy":
        vocab, unk, sentences = TOY, 0, [s for s, _ in SENTENCES] + ["", "héllo wörld"]
    else:
        (vocab, unk), sentences = fixture_vocab, _corpus_words()
    ours, theirs = Unigram(vocab, unk_id=unk), JaxUnigram(vocab, unk_id=unk)
    assert (ours.bos_id, ours.eos_id, ours.min_score) == (theirs.bos_id, theirs.eos_id,
                                                          theirs.min_score)
    for s in sentences:
        a, b = Lattice(s, ours.bos_id, ours.eos_id), JaxLattice(s, theirs.bos_id, theirs.eos_id)
        ours.populate_nodes(a)
        theirs.populate_nodes(b)
        assert _nodes(a) == _nodes(b), s
        assert [(n.id, n.pos) for n in a.viterbi()] == [(n.id, n.pos) for n in b.viterbi()], s
        assert a.nbest_tokens(2) == b.nbest_tokens(2), s
        assert [[n.id for n in p] for p in a.nbest(2)] == [[n.id for n in p] for p in b.nbest(2)]
        ea, eb = [0.0] * len(vocab), [0.0] * len(vocab)
        assert a.populate_marginal(2.0, ea) == b.populate_marginal(2.0, eb), s
        assert ea == eb, s


def test_nan_score_is_not_the_min():
    """An M-step leaves unk's score NaN: `min_score` skips it, as JAX's."""
    vocab = [("<UNK>", float("nan")), ("a", -2.0), ("b", -3.0)]
    assert Unigram(vocab, unk_id=0).min_score == JaxUnigram(vocab, unk_id=0).min_score == -3.0


# ------------------------------------------------------------ seed enumerator


def test_suffix_substrings_equal_numpy_and_jax():
    rng = np.random.default_rng(3)
    cases = [rng.integers(97, 97 + k, size=int(rng.integers(1, 80))).astype(np.int32)
             for k in (1, 2, 3, 26) for _ in range(8)]
    with open(CORPUS, encoding="utf-8") as f:
        cases.append(np.array([ord(c) for c in f.read(65536)], np.int32))
    for chars in cases:
        got = native.suffix_substrings(chars)
        assert got == native.suffix_substrings_plain(chars) == jnative.suffix_substrings(chars)
    assert native.suffix_substrings(np.zeros(0, np.int32)) == []


# --------------------------------------------------------------- piece table


def _same_table(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.max_len, a.n_pieces, a.vtab.seed, a.vtab.size) == (b.max_len, b.n_pieces,
                                                                 b.vtab.seed, b.vtab.size)
    for k in ("key_a", "key_b", "rank", "new_id"):
        np.testing.assert_array_equal(getattr(a.vtab, k), getattr(b.vtab, k))
    np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.parametrize("case", ["toy", "fixture", "duplicate", "too_long", "collision"])
def test_piece_table_equals_jax(case, fixture_vocab, monkeypatch):
    pieces = {"toy": TOY, "fixture": fixture_vocab[0],
              "duplicate": TOY + [("lo", -9.5), ("é", -1.0)],
              "too_long": TOY + [("x" * 65, -20.0)],
              "collision": TOY + [("ab", -1.0), ("ba", -2.0)]}[case]
    if case == "collision":  # multipliers of 1: "ab" and "ba" hash alike on both sides
        for mod in (tem, jem):
            monkeypatch.setattr(mod, "H1_MULT", 1)
            monkeypatch.setattr(mod, "H2_MULT", 1)
    ours, theirs = tem.PieceTable.build(pieces), jem.PieceTable.build(pieces)
    _same_table(ours, theirs)
    assert (ours is None) == (case in ("too_long", "collision"))


# ------------------------------------------------------------------ programs


def _jax_program(program, chunk, model, pt):
    buf, lens, fr = chunk
    with jax.enable_x64():
        out = program(jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(fr),
                      unk_id=np.int32(model.unk_id),
                      unk_score=np.float64(model.min_score - 10.0), max_len=pt.max_len,
                      n_pieces=len(model.vocab), **pt.device_args())
        return [np.asarray(x) for x in out]


def _torch_program(program, chunk, model, **kw):
    buf, lens, fr = (torch.from_numpy(x) for x in chunk)
    pt = tem.PieceTable.build(model.pieces)
    out = program(buf, lens, fr, table=pt.device_args("cpu"), unk_id=model.unk_id,
                  unk_score=float(np.float64(model.min_score) - 10.0), max_len=pt.max_len,
                  n_pieces=len(model.pieces), **kw)
    return [x.numpy() for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("bucket", [8, 16])
def test_programs_equal_jax(bucket):
    sentences = SENTENCES if bucket == 8 else (
        [(s * 3, n) for s, n in SENTENCES if s != "héllo"] + [("héllo" * 2 + "w", 2)])
    dev = jem.DeviceEm(sentences)
    assert [c[0].shape[1] for c in dev.chunks] == [bucket]
    chunk = dev.chunks[0][:3]
    jm, tm = JaxUnigram(TOY, unk_id=0), Unigram(TOY, unk_id=0)
    pt = jem.PieceTable.build(jm.vocab)
    je, jz, jn = _jax_program(jem.em_marginal_program, chunk, jm, pt)
    te, tz, tn = _torch_program(tem.em_marginal_program, chunk, tm)
    assert _rel(te, je) <= 1e-12 and _rel(tz, jz) <= 1e-12
    np.testing.assert_array_equal(tn, jn)
    jf, _ok = _jax_program(jem.viterbi_freq_program, chunk, jm, pt)
    (tf,) = _torch_program(tem.viterbi_freq_program, chunk, tm)
    np.testing.assert_array_equal(tf, jf)


def test_device_em_equals_host_lattices():
    model = Unigram(TOY, unk_id=0)
    sentences = SENTENCES + [LONG, ("wörld", 2)]
    dev = tem.DeviceEm(sentences, "cpu")
    assert dev.stats["host_sentences"] == 1
    e, z, ntok = dev.e_step(model)
    he, hz, hntok, hfreq = _host(model, sentences)
    assert ntok == hntok and _rel(e, he) <= 1e-12 and _rel(z, hz) <= 1e-12
    np.testing.assert_array_equal(dev.viterbi_freq(model), hfreq)
    e2, z2, ntok2 = dev.e_step(model)
    assert np.array_equal(e, e2) and np.array_equal(z, z2) and ntok == ntok2


def test_device_em_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tem.DeviceEm(SENTENCES)


def test_no_table_takes_the_host_and_is_counted():
    model = Unigram(TOY + [("x" * 70, -30.0)], unk_id=0)
    dev = tem.DeviceEm(SENTENCES, "cpu")
    assert dev.e_step(model) is None and dev.viterbi_freq(model) is None
    assert dev.stats["no_table_passes"] == 2
    cfg = UnigramTrainer(vocab_size=30, device="cpu")
    ops = ttr._TrainerOps(cfg, SENTENCES, "cpu")
    _obj, ntok, expected = ops.run_e_step(model)
    he, _hz, hntok, _hf = _host(model, SENTENCES)
    assert ntok == hntok and expected == he.tolist()


# ---------------------------------------------------------------- trainer ops


def _word_counts(lines):
    wc = {}
    for line in lines:
        for w in WhitespaceSplit().pre_tokenize(line):
            wc[w] = wc.get(w, 0) + 1
    return wc


def test_trainer_steps_equal_jax(monkeypatch):
    """Seeding, the M-step, one pruning round (the device route's Viterbi
    frequencies) and finalize against JAX's host route."""
    monkeypatch.setenv("TOKENIZERS_TPU_DEVICE_EM", "0")  # JAX's own switch, its side only
    sentences = list(_word_counts(_corpus_lines(60)).items())
    kw = dict(vocab_size=120, special_tokens=["<unk>"], unk_token="<unk>")
    jcfg, tcfg = JaxUnigramTrainer(**kw), UnigramTrainer(**kw, device="cpu")
    jops, tops = jtr._TrainerOps(jcfg, sentences), ttr._TrainerOps(tcfg, sentences, "cpu")
    seeds = tops.make_seed_sentence_pieces()
    assert seeds == jops.make_seed_sentence_pieces() and len(seeds) > 300
    assert tops.required_chars() == jops.required_chars()
    pieces = [("<UNK>", float("nan"))] + seeds
    rng = np.random.default_rng(0)
    expected = (rng.random(len(pieces)) * 3.0).tolist()
    stepped = tops.run_m_step(pieces, expected)
    jstepped = jops.run_m_step(pieces, expected)
    assert [p for p, _ in stepped] == [p for p, _ in jstepped]
    assert str(stepped) == str(jstepped)  # NaN for unk on both sides
    tm, jm = ttr._make_unigram(stepped), jtr._make_unigram(stepped)
    pruned = tops.prune_sentence_pieces(tm, stepped)
    assert pruned == jops.prune_sentence_pieces(jm, stepped) and len(pruned) < len(stepped)
    tf = tops.finalize(ttr._make_unigram(pruned), tops.required_chars())
    jf = jops.finalize(jtr._make_unigram(pruned), jops.required_chars())
    assert (tf.pieces, tf.unk_id) == (jf.vocab, jf.unk_id)
    assert tcfg.stats["no_table_passes"] == 0


def test_digamma_and_log_prob_equal_jax():
    for x in (0.3, 1.0, 6.9, 7.0, 123.456, 1e6):
        assert ttr.digamma(x) == jtr.digamma(x)
    pieces = [("a", 3.0), ("b", 1.0), ("c", 0.5)]
    assert ttr.to_log_prob(pieces) == jtr.to_log_prob(pieces)


# ------------------------------------------------------------------ training


def test_device_route_equals_host_oracle():
    corpus = ("the quick brown fox jumps over the lazy dog pack my box with five dozen "
              "liquor jugs how vexingly quick daft zebras jump").split()
    wc = {}
    for w in corpus:
        wc[w] = wc.get(w, 0) + 1
    models = []
    for host in (True, False):
        tr = UnigramTrainer(vocab_size=60, special_tokens=["<unk>"], unk_token="<unk>",
                            device="cpu")
        m = Unigram([("<unk>", 0.0)], unk_id=0)
        if host:
            tr.do_train_host(dict(wc), m)
        else:
            tr.words = dict(wc)
            tr.train(m)
        assert tr.stats["path"] == ("host" if host else "device")
        models.append(m.pieces)
    v_host, v_dev = models
    assert [p for p, _ in v_host] == [p for p, _ in v_dev]
    for (p, sh), (_, sd) in zip(v_host, v_dev):
        assert math.isclose(sh, sd, rel_tol=1e-7, abs_tol=1e-9), p


def test_training_equals_the_wheel():
    """JAX's `test_matches_reference_trainer` for the port: the first 250
    corpus lines, WhitespaceSplit, vocab 100, on the device route."""
    corpus = _corpus_lines(250)
    ref = WheelTokenizer(wmodels.Unigram())
    ref.pre_tokenizer = wpre.WhitespaceSplit()
    ref.train_from_iterator(corpus, wtrainers.UnigramTrainer(
        vocab_size=100, special_tokens=["<unk>"], unk_token="<unk>", show_progress=False))
    ref_vocab = json.loads(ref.to_str())["model"]["vocab"]
    model = Unigram([("<unk>", 0.0)], unk_id=0)
    tr = UnigramTrainer(vocab_size=100, special_tokens=["<unk>"], unk_token="<unk>",
                        device="cpu")
    tr.feed(corpus, WhitespaceSplit().pre_tokenize)
    tr.train(model)
    assert tr.stats["em_rounds"] > 5 and tr.stats["no_table_passes"] == 0
    rd, md = dict((p, s) for p, s in ref_vocab), dict(model.pieces)
    assert len(model.pieces) == len(ref_vocab) and set(rd) == set(md)
    for p in rd:
        assert math.isclose(rd[p], md[p], rel_tol=1e-6, abs_tol=1e-4 * 16), p


# ---------------------------------------------------------------- the card


@pytest.mark.gpu
def test_gpu_device_em_matches_cpu(fixture_vocab):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    vocab, unk = fixture_vocab
    model = Unigram(vocab, unk_id=unk)
    sentences = [(w, i % 7 + 1) for i, w in enumerate(_corpus_words(3000))] + [LONG]
    out = {}
    for device in ("cuda", "cpu"):
        dev = tem.DeviceEm(sentences, device)
        out[device] = dev.e_step(model) + (dev.viterbi_freq(model),)
    (ge, gz, gn, gf), (ce, cz, cn, cf) = out["cuda"], out["cpu"]
    assert gn == cn and _rel(ge, ce) <= 1e-12 and _rel(gz, cz) <= 1e-12
    np.testing.assert_array_equal(gf, cf)


@pytest.mark.parametrize("name", ["trained", "round_trip"])
def test_to_str_round_trip_moves_what_the_wheels_moves(name):
    """The committed trained model (`data/unigram_train.json`) held exactly
    gives the wheel's ids, and after `to_str` and `from_str` those of the
    wheel's own round trip (`data/unigram_round_trip_digests.json`, the
    witness of `chip_smoke.py` phase 17 (c)): on every document whose ids
    the lossy parse of the scores moves, and on the first eight."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.smoke_data import (
        build_docs, ids_digest, load_unigram_round_trip_digests, load_unigram_train, recipe_json,
    )

    want = load_unigram_round_trip_digests()
    moved = [i for i, (a, b) in enumerate(zip(want["trained"], want["round_trip"])) if a != b]
    assert moved
    pick = sorted(set(moved) | set(range(8)))
    docs = build_docs()
    committed = load_unigram_train()
    tok = Tokenizer.from_str(recipe_json("unigram"), device="cpu")
    tok.model = Unigram([tuple(p) for p in committed["vocab"]], committed["unk_id"])
    tok.add_special_tokens(["<unk>"])
    if name == "round_trip":
        tok = Tokenizer.from_str(tok.to_str(), device="cpu")
    got = [ids_digest(e.ids) for e in tok.encode_batch_fast([docs[i] for i in pick])]
    assert got == [want[name][i] for i in pick]
