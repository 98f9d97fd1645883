"""The port's multi-process runtime (`parallel/runtime.py`) in one process.

* `initialize()` is a no-op in a single process (False, no group), as
  JAX's; NCCL with a rank past the node's cards raises, naming gloo;
* bad mesh axes raise ValueError, as in JAX's `build_mesh`;
* in a gloo group of one rank (a file store, this process): `build_mesh`
  and a `TOKENIZERS_TPU_MESH` default mesh have the shapes and axis names
  of JAX's at one device; every sharded entry point (`shard_encode_batch`
  on six pipelines, every engine; both BPE trainers' mesh paths;
  `DeviceEm` and `UnigramTrainer` with a mesh) equals the unsharded run,
  bit for bit;
* a rank's block sized as the whole chunk (`geom_rows`) gives the chunk's
  rows, where sized as itself it flags most of them; on a chunk that
  overflows its unique buffer, the flagged rows fall as ranks are added
  (pinned counts at 1, 2 and 4 ranks), and the rows left unflagged keep
  their ids.

About 20 s serially.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from tokenizers_tpu.parallel import runtime as jrt

import torch_rank_jobs as jobs
from tokenizers_tpu_torch import Tokenizer, smoke_data
from tokenizers_tpu_torch.models.bpe import BPE
from tokenizers_tpu_torch.models.unigram import Unigram
from tokenizers_tpu_torch.ops.packing import pack_batch
from tokenizers_tpu_torch.ops.unigram_em_step import DeviceEm
from tokenizers_tpu_torch.parallel import (
    DistributedBpeTrainer, runtime, shard_encode_batch, shard_encode_batch_arrays,
)
from tokenizers_tpu_torch.parallel.bpe_train import train_per_round
from tokenizers_tpu_torch.trainers import BpeTrainer, UnigramTrainer

WORDS = {"low": 5, "lower": 2, "newest": 6, "widest": 3, "aaaa": 2, "abab": 4}
EM_SENTENCES = [("hello", 5), ("world", 3), ("hell", 2), ("low", 7), ("héllo", 2),
                ("lowerhello", 1)]
EM_PIECES = [("<unk>", 0.0), ("h", -2.0), ("e", -2.5), ("l", -1.5), ("o", -2.2),
             ("w", -3.0), ("r", -3.1), ("he", -3.3), ("ll", -2.9), ("low", -4.0)]


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", runtime.ENV_MESH):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(runtime, "_default_mesh", None)
    monkeypatch.setattr(runtime, "_env_mesh_tried", False)
    assert runtime.initialize() is False
    assert not dist.is_initialized() and not runtime.is_multi_process()
    assert runtime.get_default_mesh() is None and runtime.sharded_mesh() is None


def test_nccl_needs_a_card_a_rank(tmp_path):
    with pytest.raises(RuntimeError, match="gloo"):
        runtime.initialize(f"file://{tmp_path}/store", 2, 1, device="cuda", backend="nccl")
    assert not dist.is_initialized()


@pytest.mark.parametrize("axes", [(), ("hosts", "data", "more")])
def test_bad_axes_raise_as_in_jax(axes):
    with pytest.raises(ValueError):
        jrt.build_mesh(axes, devices=jax.devices()[:1])
    with pytest.raises(ValueError):
        runtime.build_mesh(axes)


@pytest.mark.parametrize("axes", [("data", "data"), ("",), ("data", 3)])
def test_malformed_axes_raise(axes):
    with pytest.raises(ValueError):
        runtime.build_mesh(axes)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A gloo group of this process alone, and its 1-D mesh."""
    store = tmp_path_factory.mktemp("store") / "store"
    assert runtime.initialize(f"file://{store}", 1, 0, device="cpu")
    assert runtime.initialize() is True  # idempotent
    yield runtime.build_mesh(("data",))
    runtime.shutdown()
    assert not dist.is_initialized()


@pytest.mark.parametrize("axes", [("data",), ("hosts", "data")])
def test_build_mesh_matches_jax(mesh, axes):
    got = runtime.build_mesh(axes)
    want = jrt.build_mesh(axes, devices=jax.devices()[:1])
    assert (tuple(got.shape), got.mesh_dim_names) == (tuple(want.devices.shape),
                                                      tuple(want.axis_names))


@pytest.mark.parametrize("spec", ["data", "hosts,data"])
def test_env_mesh_matches_jax(mesh, monkeypatch, spec):
    monkeypatch.setenv(runtime.ENV_MESH, spec)
    for mod in (runtime, jrt):
        monkeypatch.setattr(mod, "_default_mesh", None)
        monkeypatch.setattr(mod, "_env_mesh_tried", False)
    got, want = runtime.get_default_mesh(), jrt.get_default_mesh()
    assert got.mesh_dim_names == tuple(want.axis_names) == tuple(spec.split(","))
    assert tuple(got.shape) == (1,) * len(want.axis_names)
    assert runtime.sharded_mesh() is None  # one rank: the engines do not shard


@pytest.mark.parametrize("name", jobs.ENCODE_CONFIGS)
def test_one_rank_encode_equals_unsharded(mesh, name):
    tok = Tokenizer.from_str(smoke_data.config_json(name), device="cpu")
    eng = tok._get_device_engine()
    inputs = jobs.encode_inputs()
    got = shard_encode_batch_arrays(eng, inputs, mesh)
    chunks = pack_batch([eng._prepare(s) for s in inputs])
    assert len(got) == len(chunks)
    for (ids, ntok, bad, orig), (buf, lengths, orig_w) in zip(got, chunks):
        want = eng._program_mesh(buf, lengths, buf.shape[0])
        assert list(orig) == list(orig_w)
        want_bad = want[2].clone()
        if len(want) > 3:  # rows with patch records are flagged
            want_bad[want[3][0][:int(want[3][1]), 0].long()] = True
        assert ids.equal(want[0]) and ntok.equal(want[1]) and bad.equal(want_bad)
    lists = shard_encode_batch(eng, inputs, mesh)
    flagged = {i for *_x, bad, orig in got for r, i in enumerate(orig) if bad[r]}
    for i, ids in enumerate(lists):
        if i not in flagged:
            assert ids == tok.encode_host(inputs[i], False).ids, (name, i)


def test_block_buffers_sized_as_the_chunk():
    """A rank's block of the dry run's [32, 4096] gpt2 chunk, its buffers
    sized as the whole chunk's (`geom_rows`), gives the chunk's rows;
    sized as itself, its smaller unique buffer overflows and it flags
    most of its rows where the chunk flags none."""
    from tokenizers_tpu_torch import entry
    from tokenizers_tpu_torch.ops.bpe_encode import encode_core

    tok = Tokenizer.from_file(entry.FIXTURE, device="cpu")
    T = tok._get_device_engine().tables
    _docs, buf, lengths = entry._encode_docs(
        entry._corpus(entry.DRYRUN_CORPUS_BYTES).encode("utf-8"), 32, 4096)
    b, n = torch.from_numpy(buf), torch.from_numpy(lengths)

    def run(rows, geom_rows=None):
        return encode_core(b[:rows], n[:rows], T, ascii_only=False, boundary=T["boundary"],
                           whole_word=T["whole_word"], geom_rows=geom_rows)

    chunk, block, alone = run(32), run(16, 32), run(16)
    assert not chunk[2].any()
    for x, y in zip(block, chunk):
        assert x.equal(y[:16])
    assert int(alone[2].sum()) > 8


# flagged rows of the overflowing [32, 4096] chunk by the ranks it is split
# over: the rows whose words miss the unique buffer, which each rank sizes
# as the whole chunk's and fills with its own block's words only
OVERFLOW_FLAGS = {1: 20, 2: 4, 4: 4}


@pytest.mark.parametrize("ranks", sorted(OVERFLOW_FLAGS))
def test_flags_fall_as_ranks_are_added(ranks):
    """The dry run's [32, 4096] gpt2 chunk with two rows of distinct random
    words at the head of each half: the whole chunk (one rank, the global
    shape of JAX's mesh program) overflows its unique buffer and flags 20
    rows; split over 2 or 4 ranks, each block fits more of its words in a
    buffer of the same size and the chunk flags 4.  Rows that no layout
    flags have the same ids."""
    from tokenizers_tpu_torch import entry
    from tokenizers_tpu_torch.ops.bpe_encode import encode_core

    tok = Tokenizer.from_file(entry.FIXTURE, device="cpu")
    T = tok._get_device_engine().tables
    R, L = 32, 4096
    _docs, buf, lengths = entry._encode_docs(
        entry._corpus(entry.DRYRUN_CORPUS_BYTES).encode("utf-8"), R, L)
    for r, d in zip((0, 1, R // 2, R // 2 + 1), smoke_data.dense_docs(4, L - 64, seed=1)):
        d = d.encode("utf-8")
        buf[r] = 0
        buf[r, :len(d)] = np.frombuffer(d, np.uint8)
        lengths[r] = len(d)
    b, n = torch.from_numpy(buf), torch.from_numpy(lengths)

    def run(ranks):
        per = R // ranks
        parts = [encode_core(b[lo:lo + per], n[lo:lo + per], T, ascii_only=False,
                             boundary=T["boundary"], whole_word=T["whole_word"], geom_rows=R)
                 for lo in range(0, R, per)]
        return [torch.cat([p[k] for p in parts]) for k in range(3)]

    ids, ntok, bad = run(ranks)
    assert int(bad.sum()) == OVERFLOW_FLAGS[ranks]
    ids1, ntok1, bad1 = run(1)
    assert bool((bad1 | ~bad).all())  # a row flagged on several ranks is flagged on one
    ok = ~bad1
    assert ntok[ok].equal(ntok1[ok]) and ids[ok].equal(ids1[ok])


@pytest.mark.parametrize("setting", range(len(jobs.TRAIN_SETTINGS)))
def test_one_rank_bpe_equals_unsharded(mesh, setting):
    kw = dict(jobs.TRAIN_SETTINGS[setting], vocab_size=40, device="cpu")
    sharded, plain = BPE({}, []), BPE({}, [])
    DistributedBpeTrainer(mesh=mesh, **kw).do_train(dict(WORDS), sharded)
    DistributedBpeTrainer(**kw).do_train(dict(WORDS), plain)
    assert sharded.merges_list == plain.merges_list and sharded.vocab == plain.vocab
    runs = []
    for shard in (runtime.mesh_group(mesh), None):
        cfg = BpeTrainer(**kw)
        w2i, i2w, words, counts = cfg.prepare(dict(WORDS))
        runs.append(train_per_round(cfg, w2i, i2w, words, counts, "cpu", cfg.stats, shard))
    assert runs[0] == runs[1]
    assert [(i2w[a], i2w[b]) for (a, b), _ in runs[0]] == plain.merges_list


def test_one_rank_device_em_is_bit_equal(mesh):
    model = Unigram(EM_PIECES, unk_id=0)
    sharded, plain = DeviceEm(EM_SENTENCES, "cpu", mesh), DeviceEm(EM_SENTENCES, "cpu")
    assert sharded.stats["chunks"] == plain.stats["chunks"]
    for a, b in zip(sharded.e_step(model), plain.e_step(model)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sharded.viterbi_freq(model), plain.viterbi_freq(model))


def test_one_rank_unigram_trainer_equals_unsharded(mesh):
    words = {"abc": 2, "abd": 1, "bcd": 1, "abcd": 1, "bc": 1, "cd": 1, "ab": 1}
    pieces = []
    for m in (mesh, None):
        model = Unigram([("<unk>", 0.0)], unk_id=0)
        tr = UnigramTrainer(vocab_size=12, special_tokens=["<unk>"], unk_token="<unk>",
                            device="cpu", mesh=m)
        tr.words = dict(words)
        tr.train(model)
        pieces.append(model.pieces)
    assert pieces[0] == pieces[1]
