"""The port's merge table (`tokenizers_tpu_torch.ops.merge_table`) against
the JAX package: the plain torch pair hash against `hash_jnp`, and the
host-built cuckoo table, rows and consume-mins against the originals.
Bit-exact."""

import random

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tokenizers_tpu.ops import merge_table as jt
from tokenizers_tpu_torch.ops import merge_table as tt


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("mask,seed", [(0, 0), (1023, 3), ((1 << 14) - 1, 0x5BD1),
                                       ((1 << 20) - 1, 0x9E37), (0x7FFFFFFF, 0x7FFFFFFF)])
def test_hash_pair_matches_hash_jnp(which, mask, seed):
    rng = np.random.default_rng(mask ^ seed ^ which)
    a = rng.integers(-(1 << 31), 1 << 31, 4096, dtype=np.int64).astype(np.int32)
    b = rng.integers(-(1 << 31), 1 << 31, 4096, dtype=np.int64).astype(np.int32)
    a[:4] = [-1, 0, 0x7FFFFFFF, -(1 << 31)]
    b[:4] = [-1, 0x7FFFFFFF, 0, -1]
    want = np.asarray(jt.hash_jnp(jnp.asarray(a), jnp.asarray(b), seed, mask, which))
    got = tt.hash_pair(torch.from_numpy(a), torch.from_numpy(b), seed, mask, which)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a 0-d tensor seed hashes the same as the int
    got_t = tt.hash_pair(torch.from_numpy(a), torch.from_numpy(b),
                         torch.tensor(seed, dtype=torch.int32), mask, which)
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("n_merges", [1, 200, 3000])
def test_cuckoo_table_copy_matches(n_merges):
    rng = random.Random(n_merges)
    merges = {}
    nxt = 64
    while len(merges) < n_merges:
        a, b = rng.randrange(nxt), rng.randrange(nxt)
        if (a, b) not in merges:
            merges[(a, b)] = (len(merges), nxt)
            nxt += 1
    jtab, ttab = jt.CuckooMergeTable(merges), tt.CuckooMergeTable(merges)
    assert (jtab.seed, jtab.size) == (ttab.seed, ttab.size)
    jm, tm = jt.consume_mins(merges, nxt), tt.consume_mins(merges, nxt)
    np.testing.assert_array_equal(jm, tm)
    for t in (0, 1):
        np.testing.assert_array_equal(jtab.rows8(t, jm), ttab.rows8(t, tm))
