"""The port's data-parallel training on two gloo ranks of the CPU.

Two spawned ranks (`runtime.spawn`; they import no JAX, `torch_rank_jobs`)
train over a 1-D mesh of both:

* BPE at `tests/test_distributed_bpe_trainer.py`'s corpus, vocab and four
  settings (special tokens, min frequency, max token length, prefix and
  suffix), on the dense trainer (`DistributedBpeTrainer(mesh=...)`, the
  (index, delta) lists of every rank added on every rank) and on the
  per-round registry trainer (the round's counts summed over the ranks).
  Merges and vocab must equal the JAX package's `DistributedBpeTrainer`
  on a 2-device CPU mesh and its host `BpeTrainer`, exactly;
* `DeviceEm` on `tests/test_device_unigram_em.py`'s pieces and sentences
  and a few more (two buckets, rows padded to the ranks): its chunks must
  have the JAX package's mesh geometry, its expected counts and z equal
  JAX's sharded E-step within 1e-12 relative (the ranks' vectors are
  folded in rank order, JAX `psum`s them; and the unsharded port's, which
  sums in another order), its token counts and Viterbi frequencies
  exactly.

About 40 s serially, most of it JAX's compiles.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from test_device_unigram_em import PIECES, SENTENCES
from test_distributed_bpe_trainer import VOCAB_SIZE, _word_counts
from tokenizers_tpu.models.bpe import BPE as JBPE
from tokenizers_tpu.models.unigram import Unigram as JUnigram
from tokenizers_tpu.ops.unigram_em_step import DeviceEm as JDeviceEm
from tokenizers_tpu.parallel import DistributedBpeTrainer as JDistributedBpeTrainer
from tokenizers_tpu.trainers.bpe_trainer import BpeTrainer as JBpeTrainer

import torch_rank_jobs as jobs
from tokenizers_tpu_torch.models.unigram import Unigram
from tokenizers_tpu_torch.ops.unigram_em_step import DeviceEm
from tokenizers_tpu_torch.parallel import runtime

RANKS = 2
EM_SENTENCES = SENTENCES + [("eh", 2), ("helloworld", 2), ("lowerhello", 1),
                            ("wowowowowo", 3)]
EM_PIECES = [("<unk>", 0.0)] + PIECES


@pytest.fixture(scope="module")
def ranks():
    work = {"bpe": (_word_counts(), VOCAB_SIZE), "em": (EM_SENTENCES, EM_PIECES)}
    return runtime.spawn(jobs.parallel_job, RANKS, (work,), device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:RANKS]), ("data",))


@pytest.mark.parametrize("setting", range(len(jobs.TRAIN_SETTINGS)))
def test_sharded_bpe_matches_jax(ranks, jax_mesh, setting):
    kw = dict(jobs.TRAIN_SETTINGS[setting], vocab_size=VOCAB_SIZE, show_progress=False)
    host = JBPE()
    JBpeTrainer(**kw).do_train(_word_counts(), host)
    mesh_model = JBPE()
    JDistributedBpeTrainer(mesh=jax_mesh, **kw).do_train(_word_counts(), mesh_model)
    assert mesh_model.merges_list == host.merges_list
    for r in ranks:
        got = r["bpe"][setting]
        for path in ("dense", "per_round"):
            merges, vocab, taken = got[path]
            assert taken == path
            assert [tuple(m) for m in merges] == list(host.merges_list), path
            assert vocab == host.vocab, path


def test_device_em_geometry_matches_jax(ranks, jax_mesh):
    jdev = JDeviceEm(EM_SENTENCES, mesh=jax_mesh)
    want = [list(c[0].shape) for c in jdev.chunks]
    assert any(s % RANKS == 0 and s > n for (s, _l), n in
               zip(want, [len(c[3]) for c in jdev.chunks]))  # a padded chunk
    for r in ranks:
        assert r["em"]["chunks"] == want


def test_device_em_matches_jax_sharded(ranks, jax_mesh):
    jmodel = JUnigram(EM_PIECES, unk_id=0)
    jdev = JDeviceEm(EM_SENTENCES, mesh=jax_mesh)
    j_exp, j_z, j_ntok = jdev.e_step(jmodel)
    j_freq = np.asarray(jdev.viterbi_freq(jmodel))
    for r in ranks:
        em = r["em"]
        np.testing.assert_allclose(em["expected"], np.asarray(j_exp), rtol=1e-12, atol=0)
        np.testing.assert_allclose(em["z"], np.asarray(j_z), rtol=1e-12, atol=0)
        assert em["ntok"] == int(j_ntok)
        np.testing.assert_array_equal(em["freq"], j_freq)


def test_device_em_matches_unsharded(ranks):
    model = Unigram(EM_PIECES, unk_id=0)
    dev = DeviceEm(EM_SENTENCES, "cpu")
    exp, z, ntok = dev.e_step(model)
    freq = dev.viterbi_freq(model)
    for r in ranks:
        em = r["em"]
        np.testing.assert_allclose(em["expected"], exp, rtol=1e-12, atol=0)
        np.testing.assert_allclose(em["z"], z, rtol=1e-12, atol=0)
        assert em["ntok"] == ntok
        np.testing.assert_array_equal(em["freq"], freq)
    # every rank holds the same bits
    np.testing.assert_array_equal(ranks[0]["em"]["expected"], ranks[1]["em"]["expected"])
