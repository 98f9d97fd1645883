"""The port's word dedup (`tokenizers_tpu_torch.ops.bpe_dedup`) against the
JAX package: `buffer_geometry`, `g_excl_cumsum`, `word_hash_heads`, every
operand of `dedup_layout` and its `fits` (without the word cache, with a
cache that hits, and with the epoch reset), `layout_fits`, and
`dedup_finish` through its `encode_fn` hook on both occupancy tiers, with
the persistent cache as the engine always runs it.  Bit-exact.

The one deliberate difference, `_finish_expand`'s per-word counts indexed
by word rank (ROADMAP Queue C), is pinned on a chunk in which a compaction
overflow empties a word: the port flags that word's rows, JAX shifts every
later word's counts.

`dedup_finish` with the BPE merge and the fits / big-bucket branch choice
of `encode_core` are held against JAX in test_torch_slice.py, inside the
one whole-program JAX compile the suite affords."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tokenizers_tpu.ops import bpe_dedup as jd
from tokenizers_tpu.ops.merge_table import hash_jnp
from tokenizers_tpu_torch.ops import bpe_dedup as td
from tokenizers_tpu_torch.ops import bpe_encode as te
from tokenizers_tpu_torch.ops.layout_kernels import next_boundary

SEED = 77
B, L = 16, 512
# a small geometry with occupancy tiers: 6 unique-buffer rows of 512
# (256 usable, the rest row slack), so the cached tiers are 3 and 6 rows
GEOM = (4096, 512, 512, 256, 6)


def _chunk(kind):
    """[B, L] ASCII text of random words from a vocabulary of 50 (`rep`:
    the 3-row tier) or 150 (`mix`: all 6 rows); '#' bytes mark words the
    toy encoder flags."""
    rng = np.random.default_rng(3 if kind == "rep" else 4)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz#", np.uint8)
    vocab = [bytes(rng.choice(letters[:26], int(rng.integers(2, 9)))) for _ in range(
        50 if kind == "rep" else 150)]
    vocab += [b"#" + vocab[0], b"it's", b"42", b"..."]
    buf = np.zeros((B, L), np.uint8)
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lens[5] = 0
    for r in range(B):
        words = [vocab[i] for i in rng.integers(0, len(vocab), L)]
        row = b" ".join(words)[: lens[r]]
        buf[r, : len(row)] = np.frombuffer(row, np.uint8)
    return buf, lens


def _layout_inputs(buf, lens):
    b = torch.from_numpy(buf.astype(np.int32))
    n = torch.from_numpy(lens)
    inb = torch.arange(L)[None, :] < n[:, None]
    b = torch.where(inb, b, 0)
    bnd, _ = te.gpt2_boundaries(b, inb, None, ascii_only=True)
    return b, n, inb, bnd, next_boundary(bnd)


def _j(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


j_dedup_layout = jax.jit(jd.dedup_layout, static_argnames=("geom",))


def _same_ops(j_ops, t_ops):
    for k, (a, b) in enumerate(zip(j_ops, t_ops)):
        if k in (3, 7):  # total_u and nw are Python ints in the port
            assert int(a) == b, k
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=str(k))


@pytest.mark.parametrize("bl", [64, 4096, 65536, 1 << 18, 1 << 21])
def test_buffer_geometry(bl):
    assert td.buffer_geometry(bl) == jd.buffer_geometry(bl)


def test_g_excl_cumsum_and_word_hash_heads():
    buf, lens = _chunk("mix")
    wide = np.zeros((B, 2 * L), np.uint8)  # room for words past WORD_CAP
    wide[:, :L] = buf
    wide[1, :700] = ord("a")
    wide[2, 100:1000] = ord(" ")
    lens = np.where(np.arange(B) < 3, 2 * L, lens).astype(np.int32)
    b = torch.from_numpy(wide.astype(np.int32))
    inb = torch.arange(2 * L)[None, :] < torch.from_numpy(lens)[:, None]
    b = torch.where(inb, b, 0)
    bnd, _ = te.gpt2_boundaries(b, inb, None, ascii_only=True)
    jb, jinb, jbnd = _j(b, inb, bnd)
    np.testing.assert_array_equal(
        td.g_excl_cumsum(b).numpy(), np.asarray(jd.g_excl_cumsum(jb)))
    for mult in (jd.H1_MULT, jd.H2_MULT):
        want = jax.jit(jd.word_hash_heads)(jb, jbnd, jinb, mult)
        got = td.word_hash_heads(b, bnd, inb, int(mult))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cache_rows(ops, Sc):
    """A word cache holding every third distinct word of `ops`."""
    wh1, wh2, wvalid = ops[12].numpy(), ops[13].numpy(), ops[6].numpy()
    rows = np.zeros((Sc, 4), np.int32)
    keys = sorted({(a, b) for a, b, v in zip(wh1.ravel(), wh2.ravel(), wvalid.ravel()) if v})
    for k, (a, b) in enumerate(keys[::3]):
        slot = int(hash_jnp(jnp.int32(a), jnp.int32(b), SEED ^ 0x9E37, Sc - 1, 0))
        rows[slot] = (a, b, 10 * k, 1 + k % 4)
    return rows


@pytest.mark.parametrize("kind", ["rep", "mix"])
def test_dedup_layout_matches_jax(kind):
    buf, lens = _chunk(kind)
    b, n, inb, bnd, nxt = _layout_inputs(buf, lens)
    geom = GEOM
    args = _j(b, bnd, inb, n, nxt)
    fits, ops = td.dedup_layout(b, bnd, inb, n, nxt, SEED, geom)
    j_fits, j_ops = j_dedup_layout(*args, jnp.int32(SEED), geom)
    assert fits == bool(j_fits)
    _same_ops(j_ops, ops)
    assert td.layout_fits(ops, geom) == bool(jd.layout_fits(j_ops, geom))
    small = (4096, 512, 512, 256, 3)
    assert td.layout_fits(ops, small) == bool(jd.layout_fits(j_ops, small))

    rows = _cache_rows(ops, 1 << 12)
    for reset in (False, True):
        fits, ops_c = td.dedup_layout(b, bnd, inb, n, nxt, SEED, geom,
                                      cache=(torch.from_numpy(rows), reset))
        j_fits, j_ops_c = j_dedup_layout(*args, jnp.int32(SEED), geom,
                                         cache=(jnp.asarray(rows), jnp.bool_(reset)))
        assert fits == bool(j_fits)
        _same_ops(j_ops_c, ops_c)
        assert bool(ops_c[8].any()) != reset  # the cache hits unless reset


def _enc_jax(b_u, uhead, inb_u, wid_u, wend_f, upos_f):
    ids = jnp.where(inb_u, b_u + 1000, -1)
    ids = jnp.where(inb_u & ~uhead & (b_u == ord("e")), -1, ids)
    return ids, wid_u, inb_u & (b_u == ord("#"))


def _enc_torch(b_u, uhead, inb_u, wid_u, wend_f, upos_f):
    ids = torch.where(inb_u, b_u + 1000, -1)
    ids = torch.where(inb_u & ~uhead & (b_u == ord("e")), -1, ids)
    return ids, wid_u, inb_u & (b_u == ord("#"))


j_dedup_finish = jax.jit(jd.dedup_finish,
                         static_argnames=("out_w", "geom", "encode_fn"))


@pytest.mark.parametrize("kind", ["rep", "mix"])
def test_dedup_finish_matches_jax(kind):
    buf, lens = _chunk(kind)
    b, n, inb, bnd, nxt = _layout_inputs(buf, lens)
    geom = GEOM
    Sc, CAP = 1 << 12, (1 << 14) - 1
    crows = torch.zeros((Sc, 4), dtype=torch.int32)
    fits, ops = td.dedup_layout(b, bnd, inb, n, nxt, SEED, geom, cache=(crows, False))
    assert fits
    _, j_ops = j_dedup_layout(*_j(b, bnd, inb, n, nxt), jnp.int32(SEED), geom,
                              cache=(jnp.asarray(crows.numpy()), jnp.bool_(False)))
    tier, tiered = td._tier(ops[3], geom[4], geom[3], True)
    assert tiered and tier == (3 if kind == "rep" else 6)

    out_w = L // 2
    assert (B * out_w) % geom[1] == 0
    cache = td.WordCache(Sc, CAP, "cpu")
    cache.p = 123
    j_state = (jnp.asarray(cache.rows.numpy()), jnp.asarray(cache.buf.numpy()),
               jnp.int32(123))
    zeros = np.zeros(1, np.int32)  # byte2id/merge tables: unused by encode_fn
    got = td.dedup_finish(ops, b, None, None, None, SEED, None, out_w, geom,
                          cache_state=cache, encode_fn=_enc_torch)
    want, (w_rows, w_buf, w_p) = j_dedup_finish(
        j_ops, jnp.asarray(b.numpy()), zeros, zeros, zeros, jnp.int32(SEED), zeros,
        out_w, geom, cache_state=j_state, encode_fn=_enc_jax)
    np.testing.assert_array_equal(cache.rows.numpy(), np.asarray(w_rows))
    np.testing.assert_array_equal(cache.buf.numpy(), np.asarray(w_buf))
    assert cache.p == int(w_p) > 123
    for name, g, w in zip(("ids", "ntok", "row_bad"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].any() and not got[2].all()  # '#' words flag their rows


# ---- the one deliberate difference from the JAX package (ROADMAP Queue C) --
#
# A [28, 512] chunk has a [3, 2048] unique buffer with 1536 usable columns
# per row, which the merge compacts to 1280 columns after two rounds.
# English rows fill unique row 0 exactly (a filler word makes up the
# difference).  Then three 500-byte runs of control bytes, which no merge
# touches, and a 36-byte one fill unique row 1, so that row overflows: the
# compaction keeps A, B and the head of C, and D vanishes.  More English
# rows follow; their new words go to unique row 2.

QC_B, QC_L = 28, 512
QC_GEOM = td.buffer_geometry(QC_B * QC_L)
GPT2 = "tests/fixtures/gpt2/tokenizer.json"
CONTROL = ["\x01" * 500, "\x02" * 500, "\x03" * 500, "\x04" * 36]


def _qc_rows():
    """(rows, index of the first control row)."""
    from tokenizers_tpu_torch.pre_tokenizers.byte_level import gpt2_split

    text = open("tests/fixtures/corpus.txt", encoding="utf-8").read().splitlines()
    lines = [s for s in text if s.isascii() and 150 <= len(s) <= 500]
    seen, rows, used = set(), [], 0
    for line in lines:
        new = [w for w in dict.fromkeys(gpt2_split(line.encode())) if w not in seen]
        n = sum(map(len, new))
        if used + n > 1536 - 40:
            break
        seen.update(new)
        rows.append(line)
        used += n
    rows.append(" " + "q" * (1536 - used - 1))  # one new word: row 0 ends at 1536
    first = len(rows)
    rows += CONTROL
    later = [s for s in dict.fromkeys(text) if s.isascii() and 60 <= len(s) < 150]
    return rows + later[:8], first


def _qc_run(rows):
    """The port's encode_core on the chunk, and the JAX package's
    `dedup_finish` on the same layout and merged unique buffer (the port's
    merge, handed in through `encode_fn`), with the port's own
    `dedup_finish` on it too.  Returns (port, jax, injected port), each (ids, ntok, row_bad),
    and the merge's per-row overflow flags."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops.bpe_merge2 import run_merge_phases

    T = Tokenizer.from_file(GPT2, device="cpu")._get_device_engine().tables
    buf = np.zeros((QC_B, QC_L), np.uint8)  # rows past len(rows) stay empty
    lens = np.array([len(r) for r in rows] + [0] * (QC_B - len(rows)), np.int32)
    for i, r in enumerate(rows):
        buf[i, : len(r)] = np.frombuffer(r.encode(), np.uint8)
    port = te.encode_core(torch.from_numpy(buf), torch.from_numpy(lens), T, ascii_only=True)

    b = torch.where(torch.arange(QC_L)[None, :] < torch.from_numpy(lens)[:, None],
                    torch.from_numpy(buf.astype(np.int32)), 0)
    n = torch.from_numpy(lens)
    inb = torch.arange(QC_L)[None, :] < n[:, None]
    bnd, _ = te.gpt2_boundaries(b, inb, None, ascii_only=True)
    nxt = next_boundary(bnd)
    fits, ops = td.dedup_layout(b, bnd, inb, n, nxt, T["seed"], QC_GEOM)
    assert fits
    b_u, _uh, inb_u, wid_u, _we, _up = td.unique_buffer(ops, b, QC_GEOM)
    ids0 = torch.where(inb_u, T["byte2id"][b_u.to(torch.int64)], -1)
    ids_u, wid_u2, bad = run_merge_phases(ids0, wid_u, T["merge_rows0"], T["merge_rows1"],
                                          T["seed"], T["merge_mclr"])
    bad_m = bad[:, None].expand(ids_u.shape)
    out_w = QC_L // 2
    injected = td.dedup_finish(ops, b, None, None, None, T["seed"], None, out_w, QC_GEOM,
                               encode_fn=lambda *_: (ids_u, wid_u2, bad_m))
    consts = tuple(jnp.asarray(x.numpy()) for x in (ids_u, wid_u2, bad_m))
    # the port's layout, which test_dedup_layout_matches_jax holds equal to
    # JAX's: one JAX compile fewer
    j_ops = tuple(jnp.int32(x) if isinstance(x, int) else jnp.asarray(x.numpy())
                  for x in ops)
    zeros = np.zeros(1, np.int32)
    jax_out = j_dedup_finish(
        j_ops, jnp.asarray(b.numpy()), zeros, zeros, zeros, jnp.int32(T["seed"]), zeros,
        out_w, QC_GEOM, encode_fn=lambda *_: consts)
    return (tuple(x.numpy() for x in port), tuple(np.asarray(x) for x in jax_out),
            tuple(x.numpy() for x in injected), bad)


def _row(out, r):
    ids, ntok, bad = out
    return bool(bad[r]), list(ids[r][: ntok[r]])


def test_vanished_word_flags_its_rows_where_jax_shifts():
    from tokenizers import Tokenizer as WheelTokenizer

    rows, first = _qc_rows()
    assert QC_GEOM[3:] == (1536, 3) and len(rows) <= QC_B
    port, jax_out, injected, merge_bad = _qc_run(rows)
    for a, b in zip(port, injected):  # the injected merge is the real one
        np.testing.assert_array_equal(a, b)
    wheel = [e.ids for e in WheelTokenizer.from_file(GPT2).encode_batch_fast(rows)]
    assert merge_bad.tolist() == [False, True, False]  # unique row 1 overflowed
    control = set(range(first, first + 4))
    # the port flags exactly the rows of the overflowed unique row's words,
    # the vanished word D's among them, and its other rows equal the wheel
    assert {r for r in range(len(rows)) if port[2][r]} == control
    for r in set(range(len(rows))) - control:
        assert _row(port, r) == (False, wheel[r]), r
    # JAX agrees on every row ranked before D: the rows of unique row 0 and
    # the flagged rows of A, B and C
    for r in range(first + 3):
        assert _row(jax_out, r) == _row(port, r), r
    # from D on, JAX reads each word's counts one word late: D's row and
    # later rows come out wrong, and unflagged
    assert _row(jax_out, first + 3)[0] is False
    assert _row(jax_out, first + 3)[1] != wheel[first + 3]
    wrong = [r for r in range(first + 4, len(rows)) if _row(jax_out, r) != (False, wheel[r])
             and not _row(jax_out, r)[0]]
    assert len(wrong) >= 2
