"""Merge kernels B1/B2/B4 of the torch port (plain versions on the CPU)
against the JAX package: the lax `merge_round` + `hash_jnp` oracle and the
Pallas kernels in interpret mode.  Bit-exact.  The CUDA kernels themselves
are held against the same plain versions by the `gpu` tests on a card (the
row and cluster kernels of B1 and B4, and B2, on the adversarial layouts of
`smoke_data.adversarial_case` too), and by chip_smoke.py;
`run_merge_phases` is in test_torch_merge_phases.py."""

import functools
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tokenizers_tpu.ops import bpe_merge2 as jm
from tokenizers_tpu.ops import merge_pallas as jp
from tokenizers_tpu.ops.merge_table import CuckooMergeTable, consume_mins, hash_jnp
from tokenizers_tpu_torch.ops import bpe_merge2 as tm
from tokenizers_tpu_torch.ops import merge_kernels as tk
from tokenizers_tpu_torch.ops import kernel_build
from tokenizers_tpu_torch.ops.merge_table import CuckooMergeTable as PortMergeTable
from tokenizers_tpu_torch.ops.merge_table import consume_mins as port_consume_mins
from tokenizers_tpu_torch.smoke_data import adversarial_case
from tokenizers_tpu_torch.tools import timing

# the lax oracle as one XLA program (op by op it costs ~5x more here)
j_merge_round = jax.jit(jm.merge_round, static_argnames=("k_steps",))


def random_table(rng, n_base, n_merges):
    merges = {}
    next_id = n_base
    for rank in range(n_merges):
        for _ in range(50):
            a = rng.randrange(next_id)
            b = rng.randrange(next_id)
            if (a, b) not in merges:
                merges[(a, b)] = (rank, next_id)
                next_id += 1
                break
    return merges


def random_case(seed, R, C, k):
    """The random well-formed table and mid-merge layout of
    tests/test_merge_pallas.py."""
    rng = random.Random(seed)
    merges = random_table(rng, 8, 120)
    table = CuckooMergeTable(merges)
    n_ids = max(nid for _r, nid in merges.values()) + 1
    mclr = consume_mins(merges, n_ids)
    ids = np.full((R, C), -1, np.int32)
    wid = np.full((R, C), -1, np.int32)
    for r in range(R):
        col = 0
        w = 0
        while col < C - 4:
            wl = rng.randrange(1, 12)
            for _ in range(min(wl, C - 1 - col)):
                ids[r, col] = rng.randrange(8)
                wid[r, col] = w
                col += 1
            w += 1
            if rng.random() < 0.2:
                col += rng.randrange(1, 1 << min(k, 3))
        for _ in range(8):
            ids[r, rng.randrange(C)] = -1
    return table, mclr, ids, wid


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("seed,R,C,k", [(0, 8, 256, 9), (1, 5, 384, 9),
                                        (2, 16, 256, 4), (3, 8, 256, 2)])
def test_plain_round_matches_jax(seed, R, C, k):
    table, mclr, ids, wid = random_case(seed, R, C, k)
    rows0, rows1 = table.rows8(0, mclr), table.rows8(1, mclr)
    s = table.seed
    mask = rows0.shape[0] - 1

    # keys (B2) against the Pallas keys kernel and hash_jnp
    j_h0, j_h1, j_nid = jp.keys_pallas(jnp.asarray(ids), jnp.asarray(rows0),
                                       jnp.int32(s), k_steps=k, interpret=True)
    t_h0, t_h1, t_nid = tk.keys(_t(ids), _t(rows0), s, k_steps=k)
    for a, b in ((j_h0, t_h0), (j_h1, t_h1), (j_nid, t_nid)):
        np.testing.assert_array_equal(np.asarray(a)[:R], b.numpy())
    np.testing.assert_array_equal(
        np.asarray(hash_jnp(jnp.asarray(ids), j_nid[:R], s, mask, 1)), t_h1.numpy()
    )

    # three rounds: lax merge_round, the fused Pallas round (interpret) and
    # the port's fused round (carried keys) must agree at every step
    jids, jwid = jnp.asarray(ids), jnp.asarray(wid)
    jl, jr = jm.init_own(jids, jnp.asarray(mclr))
    lax_st = (jids, jl, jr)
    pst = (jp._pad_rb(jids, -1), jp._pad_rb(jl, 0), jp._pad_rb(jr, 0), j_h0, j_h1, j_nid)
    wid_p = jp._pad_rb(jwid, -1)
    tl, trr = tm.init_own(_t(ids), _t(mclr))
    tst = (_t(ids), tl, trr, t_h0, t_h1, t_nid)
    for _ in range(3):
        a1, l1, r1, f1 = j_merge_round(
            *lax_st, jwid, jm._seg_of(jwid), jnp.asarray(rows0),
            jnp.asarray(rows1), jnp.int32(s), k_steps=k,
        )
        lax_st = (a1, l1, r1)
        p_out = jp.merge_round_fused(
            *pst[:3], wid_p, *pst[3:], jnp.asarray(rows0), jnp.asarray(rows1),
            jnp.int32(s), k_steps=k, interpret=True,
        )
        pst = (p_out[0], p_out[1], p_out[2], p_out[4], p_out[5], p_out[6])
        t_out = tk.merge_round_fused(
            *tst[:3], _t(wid), *tst[3:], _t(rows0), _t(rows1), s, k_steps=k
        )
        tst = (t_out[0], t_out[1], t_out[2], t_out[4], t_out[5], t_out[6])
        np.testing.assert_array_equal(np.asarray(a1), t_out[0].numpy())
        np.testing.assert_array_equal(np.asarray(f1), t_out[3].numpy())
        for j in range(7):
            np.testing.assert_array_equal(np.asarray(p_out[j])[:R], t_out[j].numpy())
        alive = np.asarray(a1) >= 0
        np.testing.assert_array_equal(np.asarray(l1)[alive], t_out[1].numpy()[alive])
        np.testing.assert_array_equal(np.asarray(r1)[alive], t_out[2].numpy()[alive])

    # the port's self-contained lax-style round equals the fused one
    t_m = tm.merge_round(_t(ids), tl, trr, _t(wid), tm._seg_of(_t(wid)),
                         _t(rows0), _t(rows1), s, k_steps=k)
    f_1 = tk.merge_round_fused(_t(ids), tl, trr, _t(wid), t_h0, t_h1, t_nid,
                               _t(rows0), _t(rows1), s, k_steps=k)
    for j in range(4):
        np.testing.assert_array_equal(t_m[j].numpy(), f_1[j].numpy())


@pytest.mark.parametrize("seed,R,C,k", [(0, 8, 256, 9), (1, 5, 384, 9),
                                        (2, 8, 256, 2), (3, 16, 256, 4)])
def test_standalone_round_matches_jax(seed, R, C, k):
    """B4's plain version (and `_round`, which runs it on the CPU) against
    `merge_round_pallas(interpret=True)` and the lax `merge_round`, at the
    cases of tests/test_merge_pallas.py (R = 5 pads the Pallas row block)."""
    table, mclr, ids, wid = random_case(seed, R, C, k)
    rows0, rows1 = table.rows8(0, mclr), table.rows8(1, mclr)
    s = table.seed
    jl, jr = jm.init_own(jnp.asarray(ids), jnp.asarray(mclr))
    j_args = (jnp.asarray(ids), jl, jr, jnp.asarray(wid))
    j_tabs = (jnp.asarray(rows0), jnp.asarray(rows1), jnp.int32(s))
    # compiled at XLA's lowest backend optimisation level: the same program,
    # compiled in less time on the CPU
    pallas = jax.jit(functools.partial(jp.merge_round_pallas, k_steps=k, interpret=True))
    p_out = pallas.lower(*j_args, *j_tabs).compile(
        {"xla_backend_optimization_level": 0})(*j_args, *j_tabs)
    l_out = j_merge_round(*j_args, jm._seg_of(j_args[3]), *j_tabs, k_steps=k)
    tl, trr = tm.init_own(_t(ids), _t(mclr))
    t_args = (_t(ids), tl, trr, _t(wid), _t(rows0), _t(rows1), s)
    t_out = tk.merge_round_standalone(*t_args, k_steps=k)
    assert tk.merge_round_standalone_plain(*t_args, k_steps=k)[3].dtype == torch.bool
    for j in range(4):
        np.testing.assert_array_equal(t_out[j].numpy(), np.asarray(p_out[j]))
        np.testing.assert_array_equal(t_out[j].numpy(), np.asarray(l_out[j]))
    for a, b in zip(tm._round(*t_args, k_steps=k), t_out):
        assert torch.equal(a, b)
    assert t_out[3].any()


def adversarial_tables(seed, R, C, reach=512):
    """`smoke_data.adversarial_case` with its table as numpy [S, 8] rows:
    (rows0, rows1, table seed, mclr, ids, wid)."""
    merges, n_ids, ids, wid = adversarial_case(seed, R, C, reach)
    table = PortMergeTable(merges)
    mclr = port_consume_mins(merges, n_ids)
    return table.rows8(0, mclr), table.rows8(1, mclr), table.seed, mclr, ids, wid


def test_plain_round_matches_jax_adversarial():
    """B1's plain version against the lax `merge_round` and
    `merge_round_fused(interpret=True)` for three rounds on the adversarial
    layouts (every row kind of `adversarial_case`)."""
    rows0, rows1, s, mclr, ids, wid = adversarial_tables(11, 6, 1280)
    j_tabs = (jnp.asarray(rows0), jnp.asarray(rows1), jnp.int32(s))
    jids, jwid = jnp.asarray(ids), jnp.asarray(wid)
    jl, jr = jm.init_own(jids, jnp.asarray(mclr))
    j_h0, j_h1, j_nid = jp.keys_pallas(jids, j_tabs[0], j_tabs[2], interpret=True)
    # compiled at XLA's lowest backend optimisation level: the same program,
    # compiled in less time on the CPU
    fused = jax.jit(functools.partial(jp.merge_round_fused, interpret=True))
    wid_p = jp._pad_rb(jwid, -1)
    pst = (jp._pad_rb(jids, -1), jp._pad_rb(jl, 0), jp._pad_rb(jr, 0), j_h0, j_h1, j_nid)
    fused = fused.lower(*pst[:3], wid_p, *pst[3:], *j_tabs).compile(
        {"xla_backend_optimization_level": 0})
    lax_st = (jids, jl, jr)
    tl, trr = tm.init_own(_t(ids), _t(mclr))
    tst = (_t(ids), tl, trr) + tuple(tk.keys(_t(ids), _t(rows0), s))
    for x, y in zip(tst[3:], (j_h0, j_h1, j_nid)):
        np.testing.assert_array_equal(np.asarray(y)[:6], x.numpy())
    merged = 0
    for _ in range(3):
        a1, l1, r1, f1 = j_merge_round(*lax_st, jwid, jm._seg_of(jwid), *j_tabs)
        lax_st = (a1, l1, r1)
        p_out = fused(*pst[:3], wid_p, *pst[3:], *j_tabs)
        pst = (p_out[0], p_out[1], p_out[2], p_out[4], p_out[5], p_out[6])
        t_out = tk.merge_round_fused(*tst[:3], _t(wid), *tst[3:], _t(rows0), _t(rows1), s)
        tst = (t_out[0], t_out[1], t_out[2], t_out[4], t_out[5], t_out[6])
        np.testing.assert_array_equal(np.asarray(a1), t_out[0].numpy())
        np.testing.assert_array_equal(np.asarray(f1), t_out[3].numpy())
        for j in range(7):
            np.testing.assert_array_equal(np.asarray(p_out[j])[:6], t_out[j].numpy())
        merged += int(t_out[3].sum())
    assert merged > 0


def test_standalone_plain_matches_jax_adversarial():
    """B4's plain version against `merge_round_pallas(interpret=True)` for
    three rounds on the adversarial layouts (every row kind of
    `adversarial_case`) at width 1024."""
    rows0, rows1, s, mclr, ids, wid = adversarial_tables(12, 6, 1024)
    j_tabs = (jnp.asarray(rows0), jnp.asarray(rows1), jnp.int32(s))
    jids, jwid = jnp.asarray(ids), jnp.asarray(wid)
    jl, jr = jm.init_own(jids, jnp.asarray(mclr))
    # compiled at XLA's lowest backend optimisation level: the same program,
    # compiled in less time on the CPU
    pallas = jax.jit(functools.partial(jp.merge_round_pallas, interpret=True))
    pallas = pallas.lower(jids, jl, jr, jwid, *j_tabs).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    jst = (jids, jl, jr)
    tl, trr = tm.init_own(_t(ids), _t(mclr))
    tst = (_t(ids), tl, trr)
    merged = 0
    for _ in range(3):
        p_out = pallas(*jst, jwid, *j_tabs)
        t_out = tk.merge_round_standalone(*tst, _t(wid), _t(rows0), _t(rows1), s)
        for j in range(4):
            np.testing.assert_array_equal(np.asarray(p_out[j]), t_out[j].numpy())
        jst, tst = p_out[:3], t_out[:3]
        merged += int(t_out[3].sum())
    assert merged > 0


@pytest.mark.parametrize("C", [64, 257, 1024, 4096])
def test_standalone_plain_is_keys_then_fused(C):
    """The identity B4's kernel rests on: its round equals B2's keys, then
    B1's round (its first four outputs), on the adversarial layouts, round
    after round."""
    rows0, rows1, s, mclr, ids, wid = (
        _t(x) if isinstance(x, np.ndarray) else x for x in adversarial_tables(C + 3, 6, C)
    )
    st = (ids,) + tuple(tm.init_own(ids, mclr))
    merged = 0
    for _ in range(3):
        got = tk.merge_round_standalone_plain(*st, wid, rows0, rows1, s)
        chain = tk.merge_round_fused_plain(*st, wid, *tk.keys_plain(st[0], rows0, s), rows0,
                                           rows1, s)
        for a, b in zip(got, chain[:4]):
            assert torch.equal(a, b)
        st = got[:3]
        merged += int(got[3].sum())
    assert merged > 0


@pytest.mark.parametrize("C", [64, 257])
def test_table_bytes_counts_pairs_in_words(C):
    """`tools/timing.table_bytes`, the table term of the merge kernels'
    bound, against a loop over the positions: the distinct table-0 rows of
    pairs inside one word, and the distinct table-1 rows of those table 0
    does not hold, 32 B each."""
    rows0, rows1, s, mclr, ids, wid = (
        _t(x) if isinstance(x, np.ndarray) else x for x in adversarial_tables(C + 5, 6, C, 8)
    )
    h0, h1, nid = tk.keys_plain(ids, rows0, s, 3)
    want0, want1 = set(), set()
    for r in range(ids.shape[0]):
        alive = [i for i in range(C) if ids[r, i] >= 0]
        for i, j in zip(alive, alive[1:]):
            if j - i <= 8 and wid[r, i] == wid[r, j]:
                want0.add(int(h0[r, i]))
                row = rows0[h0[r, i]]
                if not (row[0] == ids[r, i] and row[1] == ids[r, j]):
                    want1.add(int(h1[r, i]))
    assert want0 and want1
    assert timing.table_bytes(ids, wid, h0, h1, rows0, rows1, 8) == 32 * (len(want0)
                                                                         + len(want1))


def test_ptxas_usage_parses_report():
    """`kernel_build.ptxas_usage` on ptxas's `-v` report: registers, spill
    bytes and static shared memory per kernel."""
    log = """ptxas info    : Compiling entry function '_Z18merge_round_kernelILb0ELb0EEvPKi' for 'sm_90a'
ptxas info    : Function properties for _Z18merge_round_kernelILb0ELb0EEvPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 1152 bytes smem, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18merge_round_kernelILb1ELb1EEvPKi' for 'sm_90a'
ptxas info    : Function properties for _Z18merge_round_kernelILb1ELb1EEvPKi
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 512 bytes cmem[0]
"""
    assert kernel_build.ptxas_usage(log) == {
        "_Z18merge_round_kernelILb0ELb0EEvPKi": dict(
            stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0, registers=64,
            static_smem_bytes=1152),
        "_Z18merge_round_kernelILb1ELb1EEvPKi": dict(
            stack_bytes=8, spill_store_bytes=8, spill_load_bytes=12, registers=64,
            static_smem_bytes=0),
    }


def _gpu_rounds(rows0, rows1, s, mclr, ids, wid, rounds=3):
    """B1 (through `bpe_merge2`'s round driver) against its plain version,
    round after round, on the card."""
    rows0, rows1 = _t(rows0).cuda(), _t(rows1).cuda()
    wid_c = _t(wid).cuda()
    ids_c = _t(ids).cuda()
    ol, orr = tm.init_own(ids_c, _t(mclr).cuda())
    init, step, _unpack = tm.make_round_driver(wid_c, rows0, rows1, s)
    st = init(ids_c, ol, orr)
    merged = 0
    for _ in range(rounds):
        ref = tk.merge_round_fused_plain(*st[:3], wid_c, *st[3:], rows0, rows1, s)
        st2, f = step(st)
        torch.cuda.synchronize()
        got = st2[:3] + (f,) + st2[3:]
        for k, (a, b) in enumerate(zip(got, ref)):
            assert torch.equal(a, b), f"output {k} differs"
        merged += int(f.sum())
        st = st2
    return merged


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 256, 1536, 2048, 2560, 4096, 5120, 8192, 16384,
                               40960, 65536])
def test_gpu_b1_adversarial(C):
    """Both B1 kernels on the adversarial layouts: the row kernel up to
    ROW_MAX_C, the cluster kernel beyond (which one ran is read from
    LAUNCHES), with words longer than one of its slices and, at 65536, a
    non-portable cluster of 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = adversarial_tables(C, 12, C)
    before = dict(tk.LAUNCHES)
    assert _gpu_rounds(*case) > 0
    wide = tk.LAUNCHES["merge_round_fused_wide"] - before["merge_round_fused_wide"]
    assert tk.LAUNCHES["merge_round_fused"] - before["merge_round_fused"] == 3
    assert wide == (3 if C > tk.ROW_MAX_C else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1001, 2560, 4096])
def test_gpu_keys_adversarial(C):
    """B2 on the adversarial layouts (dead runs of reach - 1, reach and
    reach + 1 across its 1024-wide tiles), at widths that are and are not
    multiples of its tile and of 4, and at a shorter reach; a reach above
    its 512-position halo is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows0, _rows1, s, _mclr, ids, _wid = adversarial_tables(C + 7, 12, C)
    rows0, ids = _t(rows0).cuda(), _t(ids).cuda()
    for k in (9, 4):
        before = tk.LAUNCHES["keys"]
        got = tk.keys(ids, rows0, s, k)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["keys"] == before + 1
        for name, a, b in zip(("h0", "h1", "nid"), got, tk.keys_plain(ids, rows0, s, k)):
            assert torch.equal(a, b), name
    with pytest.raises(RuntimeError):
        tk.keys(ids, rows0, s, 10)


@pytest.mark.gpu
def test_gpu_b1_row_and_wide_agree():
    """The two B1 kernels are one function: at a width both take, and on
    a row kernel width whose rows are not 16-byte multiples (the cluster
    kernel there in slices of 512, the last one short)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for C in (2048, 1001, 1004):
        rows0, rows1, s, mclr, ids, wid = (
            _t(x).cuda() if isinstance(x, np.ndarray) else x
            for x in adversarial_tables(C + 1, 12, C)
        )
        ol, orr = tm.init_own(ids, mclr)
        args = (ids, ol, orr, wid, *tk.keys(ids, rows0, s), rows0, rows1, s)
        for a, b, c in zip(tk.merge_round_fused(*args), tk.merge_round_fused_wide(*args),
                           tk.merge_round_fused_plain(*args)):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_gpu_b1_wide_refuses():
    """The cluster kernel refuses rows wider than WIDE_MAX_C before any
    launch; a launch it cannot make would raise, never fall back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows0, rows1, s, mclr, ids, wid = (
        _t(x).cuda() if isinstance(x, np.ndarray) else x
        for x in adversarial_tables(3, 1, tk.WIDE_MAX_C + 128)
    )
    ol, orr = tm.init_own(ids, mclr)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="C <= 65536"):
        tk.merge_round_fused(ids, ol, orr, wid, *tk.keys(ids, rows0, s), rows0, rows1, s)
    assert tk.LAUNCHES["merge_round_fused"] == before["merge_round_fused"]
    assert all(tk.max_clusters(*tk.cluster_geometry(R, C)) > 0
               for R, C in ((8, 8192), (32, 16384), (8, 65536)))


@pytest.mark.gpu
def test_gpu_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    table, mclr, ids, wid = random_case(7, 12, 1536, 9)
    rows0, rows1 = _t(table.rows8(0, mclr)).cuda(), _t(table.rows8(1, mclr)).cuda()
    s = table.seed
    ids_c, wid_c = _t(ids).cuda(), _t(wid).cuda()
    got = tk.keys(ids_c, rows0, s)
    want = tk.keys_plain(ids_c, rows0, s)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ol, orr = tm.init_own(ids_c, _t(mclr).cuda())
    st = (ids_c, ol, orr) + tuple(got)
    for _ in range(3):
        out = tk.merge_round_fused(*st[:3], wid_c, *st[3:], rows0, rows1, s)
        ref = tk.merge_round_fused_plain(*st[:3], wid_c, *st[3:], rows0, rows1, s)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        st = (out[0], out[1], out[2], out[4], out[5], out[6])


def _random_tables(seed, R, C, k):
    """`random_case` as `adversarial_tables` gives its case."""
    table, mclr, ids, wid = random_case(seed, R, C, k)
    return table.rows8(0, mclr), table.rows8(1, mclr), table.seed, mclr, ids, wid


@pytest.mark.gpu
@pytest.mark.parametrize("kind,C", [("adversarial", C) for C in (
    64, 256, 1536, 2048, 2560, 4096, 5120, 8192, 16384, 40960, 65536)] + [("random", 1536)])
def test_gpu_standalone_round_matches_plain(kind, C):
    """B4 on the card (through `_round`) against its plain version and
    against B2 then B1, round after round, on the adversarial layouts and
    on `random_case`'s random table: the row kernel up to ROW_MAX_C, the
    cluster kernel beyond (which one ran is read from LAUNCHES), a
    non-portable cluster of 16 at 65536."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = adversarial_tables(C, 12, C) if kind == "adversarial" else _random_tables(8, 12, C, 9)
    rows0, rows1, s, mclr, ids, wid = (
        _t(x).cuda() if isinstance(x, np.ndarray) else x for x in case
    )
    st = (ids,) + tuple(tm.init_own(ids, mclr))
    before = dict(tk.LAUNCHES)
    merged = 0
    for _ in range(3):
        out = tm._round(*st, wid, rows0, rows1, s)
        ref = tk.merge_round_standalone_plain(*st, wid, rows0, rows1, s)
        chain = tk.merge_round_fused(*st, wid, *tk.keys(st[0], rows0, s), rows0, rows1, s)
        torch.cuda.synchronize()
        for a, b, c in zip(out, ref, chain):
            assert torch.equal(a, b) and torch.equal(a, c)
        st = out[:3]
        merged += int(out[3].sum())
    assert merged > 0
    assert tk.LAUNCHES["merge_round_standalone"] == before["merge_round_standalone"] + 3
    wide = tk.LAUNCHES["merge_round_standalone_wide"] - before["merge_round_standalone_wide"]
    assert wide == (3 if C > tk.ROW_MAX_C else 0)


@pytest.mark.gpu
def test_gpu_standalone_refuses():
    """B4 refuses a row one position wider than WIDE_MAX_C before any
    launch: no tiled path is left for any width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows0, rows1, s, mclr, ids, wid = (
        _t(x).cuda() if isinstance(x, np.ndarray) else x
        for x in adversarial_tables(5, 1, tk.WIDE_MAX_C + 1)
    )
    ol, orr = tm.init_own(ids, mclr)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="C <= 65536"):
        tk.merge_round_standalone(ids, ol, orr, wid, rows0, rows1, s)
    assert tk.LAUNCHES == before
