"""The port's monotone routes (`tokenizers_tpu_torch.ops.route`, a stable
cumsum plus scatter) against the JAX butterflies of
`tokenizers_tpu.ops.route`, fuzzed in the style of tests/test_route.py:
per-row and row-major (wrap) streams, counts, fills and `n_out`.
Bit-exact on every slot."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tokenizers_tpu.ops import route as jr
from tokenizers_tpu_torch.ops import route as tr

# one XLA program per call shape: far cheaper than the butterflies' op by
# op dispatch
_STATIC = ("fills", "wrap", "n_out")
j_compact_left = jax.jit(jr.compact_left, static_argnames=("fills", "wrap"))
j_route_to = jax.jit(jr.route_to, static_argnames=_STATIC)
j_spread_right = jax.jit(jr.spread_right, static_argnames=_STATIC)


def _case(rng, R, C, density):
    live = rng.random((R, C)) < density
    a = rng.integers(0, 1 << 20, (R, C)).astype(np.int32)
    b = rng.integers(-5, 5, (R, C)).astype(np.int32)
    return live, a, b


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("shape,density", [((1, 8), 0.0), ((1, 257), 0.5),
                                           ((4, 16), 1.0), ((7, 33), 0.3),
                                           ((16, 128), 0.9)])
def test_compact_left(wrap, shape, density):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    live, a, b = _case(rng, *shape, density)
    (ja, jb), jc = j_compact_left((jnp.asarray(a), jnp.asarray(b)),
                                  jnp.asarray(live), fills=(-1, 0), wrap=wrap)
    (ta, tb), tc = tr.compact_left((torch.from_numpy(a), torch.from_numpy(b)),
                                   torch.from_numpy(live), (-1, 0), wrap=wrap)
    _same(ja, ta)
    _same(jb, tb)
    _same(jc, tc)
    assert tc.dtype == torch.int32


def _monotone_targets(rng, live, n_out, wrap):
    """Strictly increasing targets (< n_out) for the live elements, per row
    (or over the row-major stream with `wrap`)."""
    R, C = live.shape
    tgt = np.zeros((R, C), np.int32)
    rows = [live.reshape(-1)] if wrap else list(live)
    flat = tgt.reshape(len(rows), -1)
    keep = np.zeros_like(live).reshape(len(rows), -1)
    for r, lv in enumerate(rows):
        idx = np.nonzero(lv)[0][:n_out]
        keep[r, idx] = True
        flat[r, idx] = np.sort(rng.choice(n_out, size=len(idx), replace=False))
    return tgt, keep.reshape(R, C)


@pytest.mark.parametrize("trial", range(5))
@pytest.mark.parametrize("wrap", [False, True])
def test_route_to(trial, wrap):
    rng = np.random.default_rng(500 + trial + 50 * wrap)
    R, C = int(rng.integers(1, 8)), int(rng.integers(8, 64))
    live, a, _ = _case(rng, R, C, float(rng.random()) * 0.7 + 0.05)
    n_out = int(rng.integers(max(1, R - 2), 2 * R + 1)) * C if wrap else int(rng.integers(C // 2, 2 * C))
    tgt, live = _monotone_targets(rng, live, n_out, wrap)
    (ja,), jl = j_route_to((jnp.asarray(a),), jnp.asarray(live), jnp.asarray(tgt),
                           fills=(-1,), wrap=wrap, n_out=n_out)
    (ta,), tl = tr.route_to((torch.from_numpy(a),), torch.from_numpy(live),
                            torch.from_numpy(tgt), (-1,), wrap=wrap, n_out=n_out)
    _same(jl, tl)
    _same(ja, ta)


@pytest.mark.parametrize("trial", range(4))
@pytest.mark.parametrize("wrap", [False, True])
def test_spread_right(trial, wrap):
    rng = np.random.default_rng(700 + trial + 50 * wrap)
    R, C = int(rng.integers(1, 6)), int(rng.integers(8, 48))
    a = rng.integers(0, 1 << 20, (R, C)).astype(np.int32)
    n_out = int(rng.integers(R, 2 * R + 1)) * C if wrap else int(rng.integers(C, 2 * C))
    if wrap:
        k = int(rng.integers(0, R * C + 1))
        dense = (np.arange(R * C) < k).reshape(R, C)
        count = np.int32(k)
    else:
        count = rng.integers(0, C + 1, R).astype(np.int32)
        dense = np.arange(C)[None, :] < count[:, None]
    tgt, _ = _monotone_targets(rng, dense, n_out, wrap)
    (ja,), jl = j_spread_right((jnp.asarray(a),), jnp.asarray(count), jnp.asarray(tgt),
                               fills=(-1,), wrap=wrap, n_out=n_out)
    (ta,), tl = tr.spread_right((torch.from_numpy(a),), torch.from_numpy(np.asarray(count)),
                                torch.from_numpy(tgt), (-1,), wrap=wrap, n_out=n_out)
    _same(jl, tl)
    _same(ja, ta)
