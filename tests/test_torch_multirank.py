"""Ranks in processes (`runtime.spawn`), with no JAX in this file.

On the CPU: a rank that hangs fails its caller within the caller's
timeout (the other ranks are killed), and a rank that raises fails it
with the rank's traceback.

On the card (`gpu`): two gloo ranks sharing the one card run the sharded
gpt2 and unigram_bf encode, both BPE trainers and `DeviceEm`, and one rank
does the same over NCCL; each held against the port's unsharded run on
the CPU (ids, flags and merges exactly, expected counts within 1e-12
relative).  Run them with `python -m pytest tests/test_torch_multirank.py
-m gpu -q -p no:cacheprovider -o addopts=""` on a machine with a card.
"""

import time

import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from tokenizers_tpu_torch import Tokenizer, smoke_data
from tokenizers_tpu_torch.models.bpe import BPE
from tokenizers_tpu_torch.models.unigram import Unigram
from tokenizers_tpu_torch.ops.unigram_em_step import DeviceEm
from tokenizers_tpu_torch.parallel import runtime
from tokenizers_tpu_torch.trainers import BpeTrainer

WORDS = {"low": 5, "lower": 2, "lowest": 1, "newer": 6, "newest": 3, "wider": 2,
         "widest": 4, "aaaa": 2, "abab": 3, "hugging": 1, "face": 2}
EM_SENTENCES = [("hello", 5), ("world", 3), ("hell", 2), ("low", 7), ("héllo", 2),
                ("lowerhello", 1), ("wowowowowo", 3)]
EM_PIECES = [("<unk>", 0.0), ("h", -2.0), ("e", -2.5), ("l", -1.5), ("o", -2.2),
             ("w", -3.0), ("r", -3.1), ("he", -3.3), ("ll", -2.9), ("low", -4.0)]
CARD_CONFIGS = ("gpt2", "unigram_bf")


def test_hung_rank_fails_within_its_timeout():
    t = time.monotonic()
    # rank 0 may still be starting on a loaded host: it may be named too
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2"):
        runtime.spawn(jobs.hang_job, 2, device="cpu", timeout_s=10)
    assert time.monotonic() - t < 60


def test_failing_rank_raises_its_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*fails on purpose"):
        runtime.spawn(jobs.fail_job, 2, device="cpu", timeout_s=120)


def _card_work():
    return {"encode": (CARD_CONFIGS,), "bpe": (WORDS, 40), "em": (EM_SENTENCES, EM_PIECES)}


def _check_card_ranks(ranks):
    inputs = jobs.encode_inputs()
    n = len(ranks)
    for name in CARD_CONFIGS:
        tok = Tokenizer.from_str(smoke_data.config_json(name), device="cpu")
        want = jobs.unsharded_chunks(tok._get_device_engine(), inputs, n)
        host = [e.ids for e in tok.encode_batch_fast(inputs)]
        for r in ranks:
            got = r["encode"][name]
            for a, b in zip(got["arrays"], want):
                assert a[3] == b[3]
                for x, y in zip(a[:3], b[:3]):
                    np.testing.assert_array_equal(x, y)
            assert got["fast"] == host
    for setting, kw in enumerate(jobs.TRAIN_SETTINGS):
        model = BPE({}, [])
        BpeTrainer(vocab_size=40, **kw).do_train(dict(WORDS), model)
        for r in ranks:
            for path in ("dense", "per_round"):
                merges, vocab, _path = r["bpe"][setting][path]
                assert [tuple(m) for m in merges] == model.merges_list and vocab == model.vocab
    dev = DeviceEm(EM_SENTENCES, "cpu")
    um = Unigram(EM_PIECES, unk_id=0)
    exp, z, ntok = dev.e_step(um)
    freq = dev.viterbi_freq(um)
    for r in ranks:
        np.testing.assert_allclose(r["em"]["expected"], exp, rtol=1e-12, atol=0)
        np.testing.assert_allclose(r["em"]["z"], z, rtol=1e-12, atol=0)
        assert r["em"]["ntok"] == ntok
        np.testing.assert_array_equal(r["em"]["freq"], freq)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_gpu_two_gloo_ranks_share_the_card(card):
    ranks = runtime.spawn(jobs.parallel_job, 2, (_card_work(), "cuda"), backend="gloo",
                          timeout_s=600)
    _check_card_ranks(ranks)


@pytest.mark.gpu
def test_gpu_one_nccl_rank(card):
    ranks = runtime.spawn(jobs.parallel_job, 1, (_card_work(), "cuda"), backend="nccl",
                          timeout_s=600)
    _check_card_ranks(ranks)
