"""Kernel B3's plain version (`tokenizers_tpu_torch.ops.layout_kernels.
layout_fused_plain`) against the JAX package: the Pallas kernel in
interpret mode and its lax oracles (`gpt2_boundaries` + `word_hash_heads`),
on the texts of tests/test_layout_pallas.py, the 600-byte word included,
and against the lax oracle on `smoke_data.adversarial_layout_case` rows.
The UTF-8 branch of the port's `gpt2_boundaries` is held against JAX's on
multi-byte text.  Bit-exact.  The `gpu` tests hold both CUDA kernels (the
row kernel up to ROW_MAX_L, the tiled one beyond) against the plain
version, the cluster kernel at every width of the long documents'
chunks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tokenizers_tpu.ops import layout_pallas
from tokenizers_tpu.ops import bpe_dedup as jd
from tokenizers_tpu.ops import bpe_encode as je
from tokenizers_tpu.ops.unicode_tables import char_class_flat
from tokenizers_tpu_torch.ops import bpe_encode as te
from tokenizers_tpu_torch.ops import layout_kernels as tl
from tokenizers_tpu_torch.smoke_data import adversarial_layout_case

L = 2048


def _ascii_texts():
    rng = np.random.default_rng(0)
    return [
        b"Hello world! don't stop y'all'll've 123 ,,  x",
        open("tests/fixtures/corpus.txt", "rb").read()[:1500]
        .decode("utf-8", "ignore").encode("ascii", "ignore"),
        bytes(rng.integers(32, 127, 700, dtype=np.uint8)),
        b"",
        b"    ",
        b"'s's's'll're' 're",
        b"a" * 600,  # word beyond WORD_CAP: the hash fill saturates
        b"\t\n  x\r\n\x0b\x0c 'd 'D   'm\n\n",
    ]


def _pack(texts):
    buf = np.zeros((len(texts), L), np.int32)
    lens = np.zeros((len(texts),), np.int32)
    for i, t in enumerate(texts):
        t = t[:L]
        buf[i, : len(t)] = np.frombuffer(t, np.uint8)
        lens[i] = len(t)
    return buf, lens


@jax.jit
def _lax_layout(b, lens, cls_table):
    B, L = b.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    inb = pos < lens[:, None]
    bnd, _ = je.gpt2_boundaries(b, inb, cls_table, ascii_only=True)
    nbp = jax.lax.cummin(jnp.where(bnd, pos, jnp.int32(0x7FFFFFFF)), axis=1, reverse=True)
    nxt = je._shift_next(nbp, jnp.int32(0x7FFFFFFF))
    return (bnd, nxt, jd.word_hash_heads(b, bnd, inb, jd.H1_MULT),
            jd.word_hash_heads(b, bnd, inb, jd.H2_MULT))


def test_layout_plain_matches_jax():
    buf, lens = _pack(_ascii_texts())
    got = tl.layout_fused_plain(torch.from_numpy(buf), torch.from_numpy(lens))
    kernel = layout_pallas.layout_fused.__wrapped__(
        jnp.asarray(buf), jnp.asarray(lens), interpret=True)
    oracle = _lax_layout(jnp.asarray(buf), jnp.asarray(lens), jnp.zeros((1,), jnp.int8))
    names = ("bnd", "nxt", "h1", "h2")
    for name, g, k, o in zip(names, got, kernel, oracle):
        np.testing.assert_array_equal(g.numpy(), np.asarray(k), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(o), err_msg=name)
    # the wrapper takes the plain version for tensors on the CPU
    via = tl.layout_fused(torch.from_numpy(buf), torch.from_numpy(lens))
    for g, v in zip(got, via):
        assert torch.equal(g, v)


@pytest.mark.parametrize("width", [256, 1024, 16384])
def test_layout_plain_matches_jax_adversarial(width):
    """Every row kind and length case of `adversarial_layout_case`:
    contractions and whitespace runs across thread, warp and tile edges,
    words of 511-513 bytes and of more than half the row; at 16384, the
    width of the cluster kernel's two slices."""
    buf, lens = adversarial_layout_case(width, 30, width)
    got = tl.layout_fused_plain(torch.from_numpy(buf), torch.from_numpy(lens))
    oracle = _lax_layout(jnp.asarray(buf), jnp.asarray(lens), jnp.zeros((1,), jnp.int8))
    for name, g, o in zip(("bnd", "nxt", "h1", "h2"), got, oracle):
        np.testing.assert_array_equal(g.numpy(), np.asarray(o), err_msg=name)
    assert got[0].sum() > width // 4 and (got[2] == 0).any() and (got[2] != 0).any()


def test_gpt2_boundaries_utf8_matches_jax():
    texts = [
        "序号123 和 ΑΒΓ déjà-vu 'll",
        "naïve café　 end\xa0x   y",
        "emoji 🙂🙂 ok's 42½ ٣٤",
        "y'all'll've  \t\n  CJK漢字かな",
        "",
    ]
    buf, lens = _pack([t.encode("utf-8") for t in texts])
    cls = char_class_flat()
    B = len(texts)
    pos = np.arange(L)[None, :]
    inb = pos < lens[:, None]
    b = np.where(inb, buf, 0).astype(np.int32)
    jb, js = jax.jit(je.gpt2_boundaries, static_argnames="ascii_only")(
        jnp.asarray(b), jnp.asarray(inb), jnp.asarray(cls), ascii_only=False)
    tb, ts = te.gpt2_boundaries(torch.from_numpy(b), torch.from_numpy(inb),
                                torch.from_numpy(cls), ascii_only=False)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tb.shape == (B, L) and tb.sum() > 20


@pytest.mark.gpu
def test_gpu_layout_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    buf, lens = _pack(_ascii_texts())
    b, n = torch.from_numpy(buf).cuda(), torch.from_numpy(lens).cuda()
    got = tl.layout_fused(b, n)
    want = tl.layout_fused_plain(b, n)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 1024, 4096, 8192, 16384, 32768, 65536])
def test_gpu_layout_adversarial(width):
    """Both B3 kernels on the adversarial rows: the row kernel up to
    ROW_MAX_L, the cluster kernel beyond, in 2, 4 and 8 slices (which one
    ran is read from LAUNCHES); bytes past a row's length must not
    matter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    buf, lens = adversarial_layout_case(width, 30, width)
    junk = buf.copy()
    cols = np.arange(width)[None, :] >= lens[:, None]
    junk[cols] = np.random.default_rng(width).integers(0, 128, int(cols.sum()))
    n = torch.from_numpy(lens).cuda()
    want = tl.layout_fused_plain(torch.from_numpy(buf).cuda(), n)
    for rows in (buf, junk):
        before = dict(tl.LAUNCHES)
        got = tl.layout_fused(torch.from_numpy(rows).cuda(), n)
        torch.cuda.synchronize()
        assert tl.LAUNCHES["layout_fused"] == before["layout_fused"] + 1
        wide = tl.LAUNCHES["layout_fused_wide"] - before["layout_fused_wide"]
        assert wide == int(width > tl.ROW_MAX_L)
        for name, g, w in zip(("bnd", "nxt", "h1", "h2"), got, want):
            assert torch.equal(g, w), name


@pytest.mark.gpu
def test_gpu_layout_wide_refuses():
    """The cluster kernel takes L % 128 == 0 from ROW_MAX_L to WIDE_MAX_L
    and raises before any launch otherwise, through `layout_fused` too: a
    row wider than WIDE_MAX_L, which `supported` sends there, is refused,
    not sent to the plain version.  The slices of every width it takes fit
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert tl.supported((2, 2 * tl.WIDE_MAX_L))
    for L in (tl.ROW_MAX_L + 64, 2 * tl.WIDE_MAX_L):
        b = torch.zeros((2, L), dtype=torch.int32, device="cuda")
        n = torch.full((2,), 5, dtype=torch.int32, device="cuda")
        before = dict(tl.LAUNCHES)
        for fn in (tl.layout_fused_wide, tl.layout_fused):
            with pytest.raises(ValueError, match="L % 128 == 0"):
                fn(b, n)
        assert tl.LAUNCHES == before
    assert all(tl.max_clusters(*tl.wide_geometry(L)) > 0 for L in (16384, 32768, 65536))
