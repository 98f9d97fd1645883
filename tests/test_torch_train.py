"""BPE, WordPiece and WordLevel training of the torch port against the JAX
package, tolerance 0 everywhere.

* The numpy-level helpers of the dense trainer (`fold_hash`,
  `seed_hash_state`, `pack_corpus`, `initial_pair_matrix`) and of the
  per-round trainer (`_hash_pair`, the `PairRegistry` slot rows) are
  bit-equal to JAX's, and the uint32 hashes to numpy uint32 arithmetic.
* The first per-round steps are bit-equal to JAX's `make_round` on a
  one-device CPU mesh: words, count, dl, dr, and the port's per-position
  lengths equal JAX's per-id lengths at the words.
* The port's device trainer (`device="cpu"`) gives the vocab and merges of
  JAX's host `BpeTrainer` on the dense and the per-round path, over plain,
  `max_token_length`, the `##` prefix, `min_frequency`, special tokens and
  `limit_alphabet`; its own host loop (the oracle) gives them too.  On
  random small corpora the two device paths agree, and they differ from
  the host loop only where the host repeats a merge (a reused id adds to
  a pair already counted or merged).
* The WordPiece and WordLevel trainers, and `Tokenizer.train_from_iterator`
  on the sp_bpe pipeline, equal JAX's.
* On a card (`gpu`): the dense selection's first-maximum tie-break, and
  the sp_bpe recipe at 30,000 trained from the whole corpus equal to the
  committed `data/sp_bpe.json`.

JAX's dense `while_loop` program is not compiled here: JAX's own
`tests/test_dense_trainer.py` holds it to the host trainer.
"""

import json

import numpy as np
import pytest
import torch

from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.models.bpe import BPE
from tokenizers_tpu_torch.models.wordlevel import WordLevel
from tokenizers_tpu_torch.models.wordpiece import WordPiece
from tokenizers_tpu_torch.ops import bpe_train_dense as dense
from tokenizers_tpu_torch.ops import bpe_train_step as step
from tokenizers_tpu_torch.parallel.bpe_train import (
    DistributedBpeTrainer, initial_pairs, registry_size, train_per_round,
)
from tokenizers_tpu_torch.pre_tokenizers.whitespace import Whitespace
from tokenizers_tpu_torch.smoke_data import CHAR_CONFIGS, CORPUS, config_json, recipe_json
from tokenizers_tpu_torch.trainers import BpeTrainer, WordLevelTrainer, WordPieceTrainer
from tokenizers_tpu_torch.trainers.bpe_trainer import merged_token
from tokenizers_tpu_torch.utils.iter import lines_with_ending

CASES = {
    "plain": {},
    "max_token_length": {"max_token_length": 4},
    "prefix": {"continuing_subword_prefix": "##"},
    "min_frequency": {"min_frequency": 5},
    "special_tokens": {"special_tokens": ["<unk>", "<pad>"]},
    "limit_alphabet": {"limit_alphabet": 40},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these loops run many small ops, which threads only
    slow down on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(nbytes):
    with open(CORPUS, encoding="utf-8") as f:
        return f.read()[:nbytes]


def _words(nbytes=100_000):
    """{word: count} of the Whitespace words of a corpus slice, in
    first-occurrence order."""
    ws = Whitespace()
    words = {}
    for line in _text(nbytes).splitlines():
        for w in ws.pre_tokenize(line):
            words[w] = words.get(w, 0) + 1
    return words


def _jax_host(words, **kw):
    from tokenizers_tpu.models.bpe import BPE as JaxBPE
    from tokenizers_tpu.trainers.bpe_trainer import BpeTrainer as JaxTrainer

    model = JaxBPE()
    trainer = JaxTrainer(show_progress=False, **kw)
    trainer.words.update(words)
    trainer.train(model)
    return model


# ---------------------------------------------------------------- helpers


def test_fold_hash_and_seed_state_match_jax():
    from tokenizers_tpu.ops import bpe_train_dense as jd

    rng = np.random.default_rng(7)
    alphabet = list("abcxyz#") + ["é", "中", "▁", "\U0001F600"]
    vocab = ["".join(rng.choice(alphabet, rng.integers(1, 9))) for _ in range(300)]
    vocab += ["##" + w for w in vocab[:40]] + ["##", "#"]
    for w in vocab[:50]:
        for mult in (dense.H1_MULT, dense.H2_MULT):
            assert dense.fold_hash(w.encode(), mult) == jd.fold_hash(w.encode(), mult)
    for prefix in ("", "##"):
        ours = dense.seed_hash_state(vocab, len(vocab) + 5, prefix)
        theirs = jd.seed_hash_state(vocab, len(vocab) + 5, prefix)
        for o, t in zip(ours, theirs):
            assert o.dtype == t.dtype and np.array_equal(o, t)
        # the composition h(a.strip(b)) = h(a) pw(b) + hs(b) (mod 2^32) in
        # numpy's uint32 arithmetic is the hash of the joined bytes
        a = rng.integers(0, len(vocab), 64)
        b = rng.integers(0, len(vocab), 64)
        n_prefix = len(prefix)
        for i, j in zip(a.tolist(), b.tolist()):
            with np.errstate(over="ignore"):
                h1 = ours[0][i] * ours[4][j] + ours[2][j]
                ps2 = ours[5][i] * ours[5][j]
            sb = vocab[j][n_prefix:] if prefix and vocab[j].startswith(prefix) else vocab[j]
            joined = (vocab[i] + sb).encode()
            assert int(h1) == jd.fold_hash(joined, dense.H1_MULT)[0]
            sa = vocab[i][n_prefix:] if prefix and vocab[i].startswith(prefix) else vocab[i]
            assert int(ps2) == dense.fold_hash((sa + sb).encode(), dense.H2_MULT)[1]
            assert int(ours[6][i] + ours[7][j]) == len(joined)


def test_pack_corpus_and_initial_pairs_match_jax():
    from tokenizers_tpu.ops import bpe_train_dense as jd

    cfg = BpeTrainer(vocab_size=300, device="cpu")
    _w2i, i2w, words, counts = cfg.prepare(_words(30_000))
    v_cap = 301
    v_pad = 384
    for ncol in (512, 1024):
        ours = dense.pack_corpus(words, counts, ncol)
        theirs = jd.pack_corpus(words, counts, ncol, 1)
        for o, t in zip(ours, theirs):
            assert np.array_equal(o, t)
        C = dense.initial_pair_matrix(*(torch.from_numpy(x) for x in ours), v_cap, v_pad)
        assert np.array_equal(C.numpy(), jd.initial_pair_matrix(*theirs, v_cap, v_pad))


def test_hash_pair_and_registry_match_jax():
    from tokenizers_tpu.ops import bpe_train_step as js

    rng = np.random.default_rng(3)
    a = rng.integers(-1, 1 << 31, 4096, dtype=np.int64).astype(np.int32)
    b = rng.integers(-1, 40000, 4096, dtype=np.int64).astype(np.int32)
    a[:8] = -1
    for mask in (0xFF, (1 << 20) - 1):
        want = js._hash_pair(a, b, mask)
        got = step._hash_pair(torch.from_numpy(a), torch.from_numpy(b), mask)
        assert np.array_equal(got.numpy(), want)
        assert [step.hash_pair_int(int(x), int(y), mask) for x, y in zip(a[:64], b[:64])] \
            == want[:64].tolist()
    pairs = {(int(x), int(y)): int(c) for x, y, c in
             zip(rng.integers(0, 500, 3000), rng.integers(0, 500, 3000), rng.integers(1, 9, 3000))}
    ours = step.PairRegistry(pairs, 8192)
    theirs = js.PairRegistry(pairs, 8192)
    for k in ("reg_a", "reg_b", "count", "slot_rows"):
        assert np.array_equal(getattr(ours, k), getattr(theirs, k)), k
    assert ours.index == theirs.index
    for x, y in ((7, 9), (499, 0), (3, 3)):
        t_touched, o_touched = [], []
        assert ours.insert(x, y, 0, o_touched) == theirs.insert(x, y, 0, t_touched)
        assert o_touched == t_touched
    assert np.array_equal(ours.slot_rows, theirs.slot_rows)


def test_round_steps_match_jax_make_round():
    """The first rounds of the per-round trainer, port against JAX's
    `make_round` on a one-device CPU mesh, with `max_token_length` and the
    `##` prefix (the length gate and an `aaa` chain both fire)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from tokenizers_tpu.ops import bpe_train_step as js

    cfg = BpeTrainer(vocab_size=400, max_token_length=3, continuing_subword_prefix="##",
                     device="cpu")
    words_ = _words(20_000)
    words_["aaaaaaa"] = 5000  # (a, a) first: a chain, merged by overlap parity
    w2i, i2w, words, counts = cfg.prepare(words_)
    v_cap = 401
    W, K = len(words), max(len(w) for w, _ in words)
    ids = np.full((W, K), -1, np.int32)
    wc = np.zeros(W, np.int32)
    for i, (w, _l) in enumerate(words):
        ids[i, :len(w)] = w
        wc[i] = counts[i]
    pairs = initial_pairs(ids, wc, v_cap)
    p_cap = registry_size(len(pairs))
    reg = js.PairRegistry(pairs, p_cap)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    select_jit, round_jit = js.make_round(mesh, p_cap, v_cap, 1 << 16)

    j_words, j_count = jnp.asarray(ids), jnp.asarray(reg.count)
    j_id2len = jnp.ones(v_cap, jnp.int32)
    j_slots, j_ra, j_rb = (jnp.asarray(x) for x in (reg.slot_rows, reg.reg_a, reg.reg_b))
    t_words = torch.from_numpy(ids.copy())
    t_lens = (t_words >= 0).to(torch.int32)
    t_count = torch.from_numpy(np.append(reg.count, np.int32(0)))
    t_slots = torch.from_numpy(reg.slot_rows.copy())
    id2len = {}
    new_pairs = 0
    for _ in range(6):
        best, sa, sb = (int(x) for x in select_jit(j_ra, j_rb, j_count))
        got = [int(x) for x in step.select(
            torch.from_numpy(reg.reg_a), torch.from_numpy(reg.reg_b), t_count[:p_cap])]
        assert got == [best, sa, sb]
        tok = merged_token(i2w[sa], i2w[sb], "##")
        new_id = w2i.get(tok, len(i2w))
        if tok not in w2i:
            i2w.append(tok)
            w2i[tok] = new_id
        new_len = id2len.get(sa, 1) + id2len.get(sb, 1)
        id2len[new_id] = new_len
        args = (reg.index[(sa, sb)], new_id, new_len, 3)
        j_words, j_count, j_id2len, dl, dr, _m, ovf = round_jit(
            j_words, jnp.asarray(wc), j_count, j_slots, j_id2len,
            *(jnp.int32(x) for x in (sa, sb) + args))
        t_words, t_lens, t_dl, t_dr = step.round_step(
            t_words, t_lens, torch.from_numpy(wc), t_count, t_slots, sa, sb, args[0], new_id,
            3, dense.reach(K), v_cap)
        assert int(ovf) == 0
        assert np.array_equal(t_words.numpy(), np.asarray(j_words))
        assert np.array_equal(t_count[:p_cap].numpy(), np.asarray(j_count))
        alive = t_words >= 0
        want_lens = np.asarray(j_id2len)[np.maximum(np.asarray(j_words), 0)]
        assert np.array_equal(t_lens.numpy(), np.where(alive.numpy(), want_lens, 0))
        assert np.array_equal(t_dl.numpy(), np.asarray(dl))
        assert np.array_equal(t_dr.numpy(), np.asarray(dr))
        new_pairs += int(np.asarray(dl).any() or np.asarray(dr).any())
        # the registry takes the new pairs as the driver does
        for arr, left in ((np.asarray(dl), True), (np.asarray(dr), False)):
            for x in np.nonzero(arr)[0]:
                key = (int(x), new_id) if left else (new_id, int(x))
                idx = reg.index.get(key)
                if idx is None:
                    idx = reg.insert(*key, 0)
                    t_slots = torch.from_numpy(reg.slot_rows.copy())
                t_count[idx] += int(arr[x])
        j_count = jnp.asarray(t_count[:p_cap].numpy())
        j_slots, j_ra, j_rb = (jnp.asarray(x) for x in (reg.slot_rows, reg.reg_a, reg.reg_b))
    assert new_pairs >= 2


def test_dense_branches_give_the_same_counts():
    """The packed-sites and the every-position delta branches of one dense
    merge add the same counts."""
    cfg = BpeTrainer(vocab_size=300, device="cpu")
    _w2i, i2w, words, counts = cfg.prepare(_words(20_000))
    ids, wid, wcnt = (torch.from_numpy(x) for x in dense.pack_corpus(words, counts, 512))
    lens = (ids >= 0).to(torch.int32)
    C0 = dense.initial_pair_matrix(ids, wid, wcnt, 301, 384)
    for nth in range(3):
        flat = C0.view(-1).clone()
        for _ in range(nth):
            flat[torch.argmax(flat)] = 0
        idx = int(torch.argmax(flat))
        sa, sb = idx // 384, idx % 384
        ctx = dense.merge_sites(ids, lens, wid, sa, sb, 9)
        n = int(ctx.n_sites)
        out = []
        for cap in (n, n - 1):
            C = C0.clone()
            dense.merge_deltas(C, ctx, wcnt, sa, sb, len(i2w), 1 << 30, n, cap)
            out.append(C)
        assert n > 1 and torch.equal(out[0], out[1])
        assert int(out[0][sa, sb]) == 0 or sa == sb


# ---------------------------------------------------------------- trainers


@pytest.fixture(scope="module")
def words100k():
    return _words(100_000)


@pytest.mark.parametrize("path", ["dense", "per_round"])
@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax_host(words100k, case, path):
    kw = dict(vocab_size=300, **CASES[case])
    want = _jax_host(words100k, **kw)
    if path == "dense":
        trainer = DistributedBpeTrainer(device="cpu", **kw)
        trainer.words.update(words100k)
        model = BPE({}, [])
        trainer.train(model)
        assert trainer.stats["path"] == "dense"
        # one read a merge, and one more when the pairs ran out first
        short = len(model.vocab) < kw["vocab_size"]
        assert trainer.stats["host_reads"] == trainer.stats["merges"] + short
    else:
        cfg = BpeTrainer(device="cpu", **kw)
        w2i, i2w, words, counts = cfg.prepare(words100k)
        stats = {}
        merges = train_per_round(cfg, w2i, i2w, words, counts, "cpu", stats)
        assert stats["path"] == "per_round"
        model = BPE({}, [])
        cfg.finalize_model(model, w2i, i2w, merges)
    assert model.merges_list == want.merges_list
    assert model.vocab == want.vocab
    assert model.continuing_subword_prefix == want.continuing_subword_prefix
    if case == "max_token_length":
        assert max(len(t) for t in model.vocab) <= 4


def test_registry_grows_and_keeps_the_merges(words100k, monkeypatch):
    """A registry sized below the pairs the training makes doubles (its
    entries keep their indices, the slot table is rebuilt); the JAX
    package's raises "registry capacity exceeded"."""
    from tokenizers_tpu_torch.parallel import bpe_train

    monkeypatch.setattr(bpe_train, "registry_size", lambda n_pairs: n_pairs + 5)
    kw = dict(vocab_size=300, max_token_length=5)
    cfg = BpeTrainer(device="cpu", **kw)
    w2i, i2w, words, counts = cfg.prepare(words100k)
    stats = {}
    merges = train_per_round(cfg, w2i, i2w, words, counts, "cpu", stats)
    assert stats["registry_grown"] >= 2
    model = BPE({}, [])
    cfg.finalize_model(model, w2i, i2w, merges)
    assert model.merges_list == _jax_host(words100k, **kw).merges_list


@pytest.mark.parametrize("case", ["plain", "prefix"])
def test_host_loop_matches_jax(words100k, case):
    kw = dict(vocab_size=300, **CASES[case])
    want = _jax_host(words100k, **kw)
    model = BPE({}, [])
    BpeTrainer(device="cpu", **kw).do_train(words100k, model)
    assert (model.merges_list, model.vocab) == (want.merges_list, want.vocab)


def _paths(words, device="cpu", **kw):
    """Merges of the host loop, the dense path and the per-round path (the
    last two on `device`)."""
    host = BPE({}, [])
    BpeTrainer(device="cpu", **kw).do_train(words, host)
    out = [host.merges_list]
    for path in ("dense", "per_round"):
        cfg = BpeTrainer(device=device, **kw)
        w2i, i2w, ws, cs = cfg.prepare(words)
        run = dense.train_dense if path == "dense" else train_per_round
        model = BPE({}, [])
        cfg.finalize_model(model, w2i, i2w, run(cfg, w2i, i2w, ws, cs, device, {}))
        out.append(model.merges_list)
    return out


def test_dense_prefix_across_the_seam():
    """With the `##` prefix, '#' + strip('##...') makes tokens that start
    with the prefix where their left part does not; JAX's hash composition
    gives them a wrong stripped identity and its `verify_merges` then sends
    the run to the per-round path.  The port mints on the host, on the
    real strings, and stays dense."""
    words = {"#a": 10, "#ab": 11, "####ab": 33, "######a": 35, "#######": 41, "#######ab": 34}
    kw = dict(vocab_size=30, continuing_subword_prefix="##")
    trainer = BpeTrainer(device="cpu", **kw)
    trainer.words.update(words)
    model = BPE({}, [])
    trainer.train(model)
    assert trainer.stats["path"] == "dense"
    want = _jax_host(words, **kw)
    assert (model.merges_list, model.vocab) == (want.merges_list, want.vocab)


@pytest.mark.parametrize("path", ["dense", "per_round"])
def test_lengths_are_per_position(path):
    """With the `##` prefix, '#' + strip('##') = '#' reuses the id of '#'
    for a token of two chars, so one id covers different chars at two
    positions; `max_token_length` gates on each position's own length, as
    the reference's `Symbol::len` (JAX's device trainers keep one length
    per id and merge otherwise here)."""
    words = {"#": 37, "c#": 11, "#ca#aac#aac": 34, "a": 51, "a#": 64, "cb#baa": 8, "bca": 66,
             "cb": 32, "###": 67}
    kw = dict(vocab_size=27, continuing_subword_prefix="##", max_token_length=5)
    host, *device = _paths(words, **kw)
    assert device[("dense", "per_round").index(path)] == host
    assert host == _jax_host(words, **kw).merges_list


def _random_corpus(rng):
    alphabet = list("ab#cd")[: rng.integers(2, 6)]
    return {"".join(rng.choice(alphabet, rng.integers(1, 14))): int(rng.integers(1, 80))
            for _ in range(rng.integers(3, 20))}


@pytest.mark.parametrize("prefix", ["", "##"])
def test_device_differs_only_where_the_host_repeats_a_merge(prefix):
    """The reference's heap loop merges a pair again when a merge that
    reuses an existing id adds to that pair after it was counted or merged:
    the heap then holds two entries of the pair, each with its own words.
    The device trainers (JAX's and the port's) merge each pair once,
    everywhere.  On random small corpora the dense and the per-round paths
    agree, and they equal the host loop unless its merges repeat a pair;
    on {'##ab', '#a', '####a', ...} the host merges ('##a', '##b') twice
    and the device paths once."""
    rng = np.random.default_rng(11 + len(prefix))
    repeats = 0
    for _ in range(60):
        kw = dict(vocab_size=int(rng.integers(10, 60)), continuing_subword_prefix=prefix or None)
        if rng.random() < 0.3:
            kw["max_token_length"] = int(rng.integers(2, 6))
        words = _random_corpus(rng)
        host, dense_m, per_round_m = _paths(words, **kw)
        assert dense_m == per_round_m, (words, kw)
        if len(set(host)) == len(host):
            assert dense_m == host, (words, kw)
        else:
            repeats += 1
    if prefix:
        assert repeats > 0
        words = {"##ab": 49, "#a": 2, "####a": 31, "######a": 14, "#######a": 28}
        host, dense_m, per_round_m = _paths(words, vocab_size=30, continuing_subword_prefix="##")
        assert host.count(("##a", "##b")) == 2 and dense_m.count(("##a", "##b")) == 1
        i = host.index(("##a", "##b"))
        assert dense_m == per_round_m == host[:i + 1] + host[i + 2:]


def test_routing_by_size(words100k):
    """Routing by size, and a word of 40,000 symbols on the per-round path
    trained until its tokens are over 2^15 symbols long: the fills reach
    across the whole row (the JAX package's fixed reach of 512 loses the
    pairs of longer tokens), so every merge is the host loop's."""
    assert dense.DENSE_VCAP_MAX == 16384
    cfg = BpeTrainer(vocab_size=dense.DENSE_VCAP_MAX, device="cpu")
    w2i, i2w, words, counts = cfg.prepare(words100k)
    assert dense.train_dense(cfg, w2i, i2w, words, counts, "cpu") is None
    long_word = {"x" * 40000: 2, "ab": 3}
    cfg = BpeTrainer(vocab_size=50, device="cpu")
    w2i, i2w, words, counts = cfg.prepare(long_word)
    assert dense.train_dense(cfg, w2i, i2w, words, counts, "cpu") is None
    trainer = BpeTrainer(vocab_size=50, device="cpu")
    trainer.words.update(long_word)
    model = BPE({}, [])
    trainer.train(model)
    host = BPE({}, [])
    BpeTrainer(vocab_size=50, device="cpu").do_train(long_word, host)
    assert trainer.stats["path"] == "per_round" and model.merges_list[0] == ("x", "x")
    assert ("x" * 1024, "x" * 1024) in model.merges_list
    assert model.merges_list == host.merges_list and model.vocab == host.vocab


def test_a_selected_pair_without_sites_raises():
    words = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    count = torch.tensor([5, 0], dtype=torch.int32)
    slots = torch.full((64, 4), -1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no site"):
        step.round_step(words, (words >= 0).to(torch.int32), torch.tensor([5]), count, slots,
                        1, 0, 0, 2, 1 << 30, 2, 4)


def test_wordpiece_trainer_matches_jax(words100k):
    from tokenizers_tpu.models.wordpiece import WordPiece as JaxWordPiece
    from tokenizers_tpu.trainers.wordpiece_trainer import WordPieceTrainer as JaxTrainer

    kw = dict(vocab_size=400, special_tokens=["[UNK]", "[CLS]"])
    want = JaxWordPiece()
    jt = JaxTrainer(show_progress=False, **kw)
    jt.bpe_trainer.words.update(words100k)
    assert [t.content for t in jt.train(want)] == ["[UNK]", "[CLS]"]
    model = WordPiece({})
    trainer = WordPieceTrainer(device="cpu", **kw)
    trainer.words.update(words100k)
    assert [t.content for t in trainer.train(model)] == ["[UNK]", "[CLS]"]
    assert trainer.stats["path"] == "dense"
    assert model.vocab == want.vocab and model.continuing_subword_prefix == "##"


def test_wordlevel_trainer_matches_jax():
    from tokenizers_tpu.models.wordlevel import WordLevel as JaxWordLevel
    from tokenizers_tpu.trainers.wordlevel_trainer import WordLevelTrainer as JaxTrainer

    lines = _text(60_000).splitlines()
    ws = Whitespace()
    for kw in (dict(vocab_size=500, special_tokens=["[UNK]"]), dict(min_frequency=3)):
        want = JaxWordLevel()
        jt = JaxTrainer(show_progress=False, **kw)
        jt.feed(lines, ws.pre_tokenize)
        jt.train(want)
        model = WordLevel({})
        trainer = WordLevelTrainer(**kw)
        trainer.feed(lines, ws.pre_tokenize)
        trainer.train(model)
        assert model.vocab == want.vocab and len(model.vocab) > 100


def test_tokenizer_train_from_iterator_sp_bpe_matches_jax(monkeypatch):
    """The sp_bpe pipeline (NFKC, Metaspace, fuse_unk) retrained on 200 KB
    of the corpus at vocab 2,000 (the dense path), against JAX's
    `Tokenizer.train_from_iterator`; the trained tokenizers encode alike."""
    from tokenizers_tpu import Tokenizer as JaxTokenizer
    from tokenizers_tpu.trainers import BpeTrainer as JaxTrainer

    # JAX's feed counts in a fork pool unless told not to; no fork in a
    # process that runs JAX's threads
    monkeypatch.setenv("TOKENIZERS_PARALLELISM", "false")

    lines = list(lines_with_ending(_text(200_000)))
    kw = dict(vocab_size=2000, min_frequency=2, limit_alphabet=1000, special_tokens=["<unk>"])
    theirs = JaxTokenizer.from_file(CHAR_CONFIGS["sp_bpe"])
    theirs.train_from_iterator(lines, JaxTrainer(show_progress=False, **kw))
    ours = Tokenizer.from_str(config_json("sp_bpe"), device="cpu")
    trainer = BpeTrainer(device="cpu", **kw)
    assert ours.train_from_iterator(lines, trainer) is ours
    assert trainer.stats["path"] == "dense"
    assert ours.model.merges_list == theirs.model.merges_list
    assert ours.model.vocab == theirs.model.vocab
    assert ours.added == {"<unk>": 0} and ours.model.fuse_unk
    texts = ["Hello world! café ﬁle", "naïve 序号 x", "x<unk>y ☃", _text(3000)]
    assert [e.ids for e in ours.encode_batch_fast(texts)] == \
        [theirs.encode(t).ids for t in texts]


@pytest.mark.parametrize("name", ["sp_bpe", "wordlevel"])
def test_train_words_split_added_tokens_as_the_wheel(name):
    """A trainer counts an added token as a word of its own and runs the
    normalizer and pre-tokenizer on the pieces between added tokens (Metaspace
    prepends to each), as the wheel trains."""
    import tokenizers as wheel

    added = {"sp_bpe": "<unk>", "wordlevel": "[UNK]"}[name]
    lines = list(lines_with_ending(_text(20_000)))
    lines += [f"x{added}y {added} z{added}\n"] * 40
    theirs = wheel.Tokenizer.from_str(config_json(name))
    ours = Tokenizer.from_str(config_json(name), device="cpu")
    assert ours.train_words(lines[-1]) == {
        "sp_bpe": ["▁x", "<unk>", "▁y", "▁", "<unk>", "▁z", "<unk>", "▁\n"],
        "wordlevel": ["x", "[UNK]", "y", "[UNK]", "z", "[UNK]"]}[name]
    if name == "sp_bpe":
        theirs.train_from_iterator(lines, wheel.trainers.BpeTrainer(
            vocab_size=300, special_tokens=["<unk>"], show_progress=False))
        trainer = BpeTrainer(vocab_size=300, special_tokens=["<unk>"], device="cpu")
        ours.train_from_iterator(lines, trainer)
        merges = json.loads(theirs.to_str())["model"]["merges"]
        assert ours.model.merges_list == [tuple(m) for m in merges]
    else:
        # no special tokens: the wheel gives a special token that is also a
        # counted word that word's rank (a hole at its special id), where
        # JAX and the port keep the special id (ROADMAP Queue C)
        theirs.train_from_iterator(lines, wheel.trainers.WordLevelTrainer(show_progress=False))
        ours.train_from_iterator(lines, WordLevelTrainer())
        assert "[UNK]" in ours.model.vocab
    assert ours.model.vocab == theirs.get_vocab(with_added_tokens=False)


def test_tokenizer_train_files_and_default_trainer(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text(_text(30_000), encoding="utf-8")
    ours = Tokenizer.from_str(config_json("wordlevel"), device="cpu")
    assert ours.train([str(path)]) is ours
    assert len(ours.model.vocab) > 100
    ours2 = Tokenizer.from_str(config_json("wordlevel"), device="cpu")
    trainer = WordLevelTrainer(special_tokens=["[UNK]"])
    ours2.train([str(path)], trainer)
    assert ours2.model.vocab["[UNK]"] == 0 and ours2.added == {"[UNK]": 0}
    ids = ours2.encode_batch_fast(["the fox"])[0].ids
    assert ids == [ours2.model.vocab.get(w, 0) for w in ("the", "fox")]
    # Unigram's default trainer (no unk token: the trained model has none)
    ours3 = Tokenizer.from_str(recipe_json("unigram"), device="cpu")
    assert ours3.train([str(path)]) is ours3
    assert len(ours3.model.pieces) > 100 and ours3.model.unk_id is None


def test_trainer_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    trainer = BpeTrainer(vocab_size=50)
    trainer.words.update({"ab": 2})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(BPE({}, []))


# ---------------------------------------------------------------- the card


@pytest.mark.gpu
def test_gpu_select_first_maximum():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for v_cap, v_pad in ((301, 384), (16001, 16128)):
        C = torch.zeros(v_cap, v_pad, dtype=torch.int32, device="cuda")
        ties = [(v_cap - 1, 3), (5000 % v_cap, 7), (17, v_pad - 1), (17, 200), (9, 300)]
        for a, b in ties:
            C[a, b] = 12345
        best, a, b = dense._select(C, v_pad)
        assert (int(best), int(a), int(b)) == (12345, 9, 300)
        C[9, 300] = 0
        assert [int(x) for x in dense._select(C, v_pad)] == [12345, 17, 200]


@pytest.mark.gpu
def test_gpu_device_paths_match_cpu():
    """Both device paths on the card give the merges they give on the CPU,
    on random small corpora with and without the `##` prefix and
    `max_token_length`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    for i in range(40):
        kw = dict(vocab_size=int(rng.integers(10, 60)),
                  continuing_subword_prefix="##" if i % 2 else None)
        if i % 3 == 0:
            kw["max_token_length"] = int(rng.integers(2, 6))
        words = _random_corpus(rng)
        assert _paths(words, "cuda", **kw)[1:] == _paths(words, "cpu", **kw)[1:], (words, kw)


@pytest.mark.gpu
def test_gpu_sp_bpe_recipe_at_full_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tok = Tokenizer.from_str(recipe_json("sp_bpe"))
    trainer = BpeTrainer(vocab_size=30000, min_frequency=2, limit_alphabet=1000,
                         special_tokens=["<unk>"])
    tok.train([CORPUS], trainer)
    assert trainer.stats["path"] == "per_round"
    model = json.loads(config_json("sp_bpe"))["model"]
    assert tok.model.vocab == model["vocab"]
    assert tok.model.merges_list == [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                                     for m in model["merges"]]
