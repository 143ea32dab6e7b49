"""Port parity for kernels 11 and 13: the plain versions of the port's row
gather / scatter (`ops/panel_fused.py`) and of its trailing GEMM with the
row exchange inside it (`ops/gemmx.py`) against the JAX package's Pallas
kernels in interpret mode, as its own tests run them
(`tests/test_gemmx.py`).  Inputs come from numpy with fixed seeds; each
test states its tolerance."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops.gemmx import gemm_trailing as j_gemm_trailing  # noqa: E402
from mpf_tpu.ops.panel_fused import (  # noqa: E402
    rows_gather as j_rows_gather,
    rows_scatter_from_band as j_scatter_band,
    rows_scatter_inplace as j_scatter,
)

from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.ops.exchange import rows_exchange_plain  # noqa: E402
from mpf_tpu_torch.ops.gemmx import gemm_trailing, gemm_trailing_plain  # noqa: E402
from mpf_tpu_torch.ops.panel_fused import (  # noqa: E402
    rows_gather, rows_scatter_from_band, rows_scatter_inplace, trailing_gemm_sub_plain)

BF = torch.bfloat16
_DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (BF, jnp.bfloat16)}


def _band_perm(rng, n, k, bc):
    """(glist, dests) of a composed exchange map, as tests/test_gemmx.py
    builds it: swaps band row i <-> a row >= k + i, in order."""
    perm = np.arange(k, n)
    for i in range(bc):
        j = rng.integers(i, n - k)
        perm[[i, j]] = perm[[j, i]]
    inv = np.empty(n - k, dtype=np.int64)
    inv[perm - k] = np.arange(n - k)
    return perm[:bc].astype(np.int32), (inv[:bc] + k).astype(np.int32)


def _t(x, dt):
    """numpy -> a torch copy in dtype dt (in-place kernels never write the
    numpy array)."""
    return torch.from_numpy(np.array(x, np.float32)).to(dt)


def _j(x, dt):
    return jnp.asarray(np.asarray(x, np.float32), dt)


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dt,gd", [("float32", "float32"), ("float32", "bfloat16"),
                                   ("bfloat16", "bfloat16")])
def test_gemm_trailing_plain_matches_jax(dt, gd):
    """n = 512, r0 = k = 128, c0 = 256, K = 128, a 64-row band map: the
    port's plain version against JAX ``gemm_trailing(interpret=True,
    ti=128, t=128)`` with ``xargs``.  Rows above r0 and columns left of c0
    exact (the exchange moves rows whole, so moved rows keep their
    untouched left columns); the rest within tests/test_gemmx.py's bound,
    max|ref| * (2^-7 for bf16 storage, 2e-6 for fp32): fp32 sums of the
    same products in another order plus one final-dtype rounding."""
    rng = np.random.default_rng(7)
    n, k, c0, kk, nr = 512, 128, 256, 128, 64
    m, w = n - k, n - c0
    a = rng.standard_normal((n, n)).astype(np.float32)
    l21 = rng.standard_normal((m, kk)).astype(np.float32)
    u12 = rng.standard_normal((kk, w)).astype(np.float32)
    glist, dests = _band_perm(rng, n, k, nr)
    tdt, jdt = _DT[dt]
    tgd, jgd = _DT[gd]
    ja, jp = j_gemm_trailing(_j(a, jdt), _j(l21, jgd), _j(u12, jgd), k, c0,
                             xargs=(k, jnp.asarray(glist), jnp.asarray(dests)),
                             interpret=True, ti=128, t=128)
    ja = np.array(_np32(ja))
    ja[k:k + nr] = _np32(jp)                       # the caller's band write
    ta = _t(a, tdt)
    _lib.reset_counts()
    _, tp = gemm_trailing(ta, _t(l21, tgd), _t(u12, tgd), k, c0,
                          xargs=(k, torch.from_numpy(glist), torch.from_numpy(dests)))
    assert _lib.plain_calls["gemmx"] == 1 and not any(_lib.launches.values())
    ta[k:k + nr] = tp
    ta = _np32(ta)
    assert (ta[:k] == ja[:k]).all() and (ta[:, :c0] == ja[:, :c0]).all()
    tol = np.abs(ja).max() * (2 ** -7 if dt == "bfloat16" else 2e-6)
    assert np.abs(ta - ja).max() <= tol


@pytest.mark.parametrize("dt,gd", [(torch.float32, torch.float32), (torch.float32, BF),
                                   (BF, BF)])
@pytest.mark.parametrize("case", ["band_map", "identity", "full_reversal"])
def test_gemm_trailing_plain_is_gemm_then_exchange(dt, gd, case):
    """Exact: the plain version with ``xargs`` equals kernel 6's plain
    version on the same region followed by kernel 4's plain exchange, for
    a random band map, the identity map (no row moves) and a band whose
    every row leaves and every pivot row comes from below."""
    rng = np.random.default_rng(8)
    n, k, c0, kk, nr = 320, 96, 200, 40, 48
    a = _t(rng.standard_normal((n, n)), dt)
    l21 = _t(rng.standard_normal((n - k, kk)), gd)
    u12 = _t(rng.standard_normal((kk, n - c0)), gd)
    if case == "band_map":
        glist, dests = (torch.from_numpy(x) for x in _band_perm(rng, n, k, nr))
    elif case == "identity":
        glist = dests = torch.arange(k, k + nr, dtype=torch.int32)
    else:
        glist = dests = torch.arange(n - 1, n - 1 - nr, -1, dtype=torch.int32)
    x, y = a.clone(), a.clone()
    _, px = gemm_trailing_plain(x, l21, u12, k, c0, xargs=(k, glist, dests))
    trailing_gemm_sub_plain(y[:, c0 - k:], l21, u12, k, ncols=n - c0)
    py = rows_exchange_plain(y, k, glist, dests)
    assert torch.equal(px, py) and torch.equal(x, y)
    if case == "identity":
        assert torch.equal(px, y[k:k + nr])
    x, y = a.clone(), a.clone()
    gemm_trailing_plain(x, l21, u12, k, c0)
    trailing_gemm_sub_plain(y[:, c0 - k:], l21, u12, k, ncols=n - c0)
    assert torch.equal(x, y)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rows_gather_matches_jax(dt):
    """Exact: 64 rows, repeats and any order, of a 256 x 384 matrix."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((256, 384)).astype(np.float32)
    rows = rng.integers(0, 256, 64).astype(np.int32)
    tdt, jdt = _DT[dt]
    j = _np32(j_rows_gather(_j(a, jdt), jnp.asarray(rows), interpret=True))
    t = rows_gather(_t(a, tdt), torch.from_numpy(rows))
    assert t.dtype == tdt and (_np32(t) == j).all()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rows_scatter_inplace_matches_jax(dt):
    """Exact, 48 rows into a 256 x 384 matrix, with self-moves
    (``self_src``: each value's current row, whose value it is), inactive
    rows whose destinations collide with active ones, and a destination
    written twice with equal values."""
    rng = np.random.default_rng(10)
    n, nr = 256, 48
    a = rng.standard_normal((n, 384)).astype(np.float32)
    dests = rng.choice(n, nr, replace=False).astype(np.int32)
    src = rng.choice(n, nr, replace=False).astype(np.int32)
    src[:6] = dests[:6]                                   # self-moves
    dests[10], src[10] = dests[11], src[11]               # equal-value duplicate
    active = np.ones(nr, bool)
    active[20:26] = False
    dests[20:26] = dests[30]                              # dropped rows collide
    vals = a[src]
    tdt, jdt = _DT[dt]
    j = _np32(j_scatter(_j(a, jdt), jnp.asarray(dests), _j(vals, jdt),
                        self_src=jnp.asarray(src), active=jnp.asarray(active),
                        interpret=True))
    t = rows_scatter_inplace(_t(a, tdt), torch.from_numpy(dests), _t(vals, tdt),
                             self_src=torch.from_numpy(src), active=torch.from_numpy(active))
    assert (_np32(t) == j).all()
    assert not (j == _np32(_t(a, tdt))).all()                # the scatter moved rows


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rows_scatter_from_band_matches_jax(dt):
    """Exact: the band [64, 128) of a 320 x 256 matrix scattered to the
    destinations of a band map, in-band destinations skipped."""
    rng = np.random.default_rng(11)
    n, k, nr = 320, 64, 64
    a = rng.standard_normal((n, 256)).astype(np.float32)
    _, dests = _band_perm(rng, n, k, nr)
    assert ((dests >= k) & (dests < k + nr)).any()
    tdt, jdt = _DT[dt]
    j = _np32(j_scatter_band(_j(a, jdt), k, jnp.asarray(dests), interpret=True))
    _lib.reset_counts()
    t = rows_scatter_from_band(_t(a, tdt), k, torch.from_numpy(dests))
    assert _lib.plain_calls["rows_scatter"] == 1 and not any(_lib.launches.values())
    assert (_np32(t) == j).all()
