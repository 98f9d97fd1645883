"""The port's `run_merge_phases` (the merge loops, with the plain versions
of kernels B1/B2 on the CPU) against the JAX package's, end to end: ids,
word ids and the compaction-overflow flags.  Bit-exact."""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_merge_round import _t, random_table
from tokenizers_tpu.ops import bpe_merge2 as jm
from tokenizers_tpu.ops.merge_table import CuckooMergeTable, consume_mins
from tokenizers_tpu_torch.ops import bpe_merge2 as tm

# one XLA program per case instead of one per loop body
j_run_merge_phases = jax.jit(jm.run_merge_phases, static_argnames=("ladder_depth",))


def _word_layout(rng, R, C, n_base):
    """Mid-encode unique-buffer rows: words of 1..40 ids, rows padded dead."""
    ids = np.full((R, C), -1, np.int32)
    wid = np.full((R, C), -1, np.int32)
    w = 0
    for r in range(R):
        col = 0
        while True:
            wl = int(rng.integers(1, 40))
            if col + wl > C - 8:
                break
            ids[r, col : col + wl] = rng.integers(0, n_base, wl)
            wid[r, col : col + wl] = w
            w += 1
            col += wl
    return ids, wid


# both ladder depths of the main path: 2 on the ru/2 occupancy tier, 0 on
# the others (the plain tail loop)
@pytest.mark.parametrize("seed,R,C,depth", [(5, 8, 256, 2), (6, 16, 512, 0)])
def test_run_merge_phases_matches_jax(seed, R, C, depth):
    rng = random.Random(seed)
    merges = random_table(rng, 6, 300)
    table = CuckooMergeTable(merges)
    n_ids = max(nid for _r, nid in merges.values()) + 1
    mclr = consume_mins(merges, n_ids)
    rows0, rows1 = table.rows8(0, mclr), table.rows8(1, mclr)
    ids, wid = _word_layout(np.random.default_rng(seed), R, C, 6)
    j_ids, j_wid, j_bad, _ = j_run_merge_phases(
        jnp.asarray(ids), jnp.asarray(wid), jnp.asarray(rows0),
        jnp.asarray(rows1), jnp.int32(table.seed), jnp.asarray(mclr),
        ladder_depth=depth,
    )
    t_ids, t_wid, t_bad = tm.run_merge_phases(
        _t(ids), _t(wid), _t(rows0), _t(rows1), table.seed, _t(mclr),
        ladder_depth=depth,
    )
    np.testing.assert_array_equal(np.asarray(j_ids), t_ids.numpy())
    np.testing.assert_array_equal(np.asarray(j_wid), t_wid.numpy())
    np.testing.assert_array_equal(np.asarray(j_bad), t_bad.numpy())
    assert (t_ids.numpy() >= 6).any()  # merges happened


