"""Port parity, kernel by kernel: each plain PyTorch version (what the port
runs on CPU tensors, and what its Hopper kernel is checked against on the
card) against its JAX counterpart — the Pallas kernel in interpret mode, as
the JAX package's own tests run it, or the jnp reference.  Inputs come from
numpy with fixed seeds; each test states its tolerance."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops import blas3 as JB  # noqa: E402
from mpf_tpu.ops.exchange import rows_exchange as j_rows_exchange  # noqa: E402
from mpf_tpu.ops.panel_fused import (  # noqa: E402
    panel_apply_update_trim as j_update,
    rowblock_assemble as j_rowblock,
)
from mpf_tpu.ops.panel_pallas import unit_lower_inv_pallas  # noqa: E402
from mpf_tpu.ops.panel_strip import strip_panel_pivots as j_strip  # noqa: E402
from mpf_tpu.precision import MPF_BF16 as J_BF16, PURE_FP32 as J_F32  # noqa: E402

from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.ops.blas3 import (  # noqa: E402
    _leaves, tri_inv_leaves, unit_lower_inv_blocked, upper_inv, unit_lower_inv)
from mpf_tpu_torch.ops.exchange import rows_exchange  # noqa: E402
from mpf_tpu_torch.ops.panel_fused import (  # noqa: E402
    panel_apply_update_trim, rowblock_assemble, trailing_gemm_sub)
from mpf_tpu_torch.ops.panel_strip import SENT, strip_panel_pivots  # noqa: E402


def _np(x):
    return np.asarray(x)


def _dyadic(rng, m, r):
    """Entries whose elimination stays exact in fp32 (test_panel_fused.py)."""
    a = (rng.integers(-4, 5, (m, r)) * 2.0 ** rng.integers(-2, 3, (m, r))).astype(np.float32)
    a[a == 0] = 1.0
    return a


# ---------------------------------------------------------------- kernel 1

@pytest.mark.parametrize("m", [128, 1024])
@pytest.mark.parametrize("mode", ["exact_f32_dyadic", "quant16_bf16"])
def test_strip_pivots_match_jax(m, mode):
    """Exact piv / pos / glist at off in {0, 8, 40}, panel at jj0=16 of a
    32-wide slab, against strip_panel_pivots(interpret=True)."""
    rng = np.random.default_rng(m + len(mode))
    if mode == "exact_f32_dyadic":
        slab = _dyadic(rng, m, 32)
        jdt, tdt = jnp.float32, torch.float32
    else:
        slab = rng.standard_normal((m, 32)).astype(np.float32)
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    for off in (0, 8, 40):
        pos = rng.permutation(m).astype(np.int32) if off == 8 else np.arange(m, dtype=np.int32)
        jp = j_strip(jnp.asarray(slab), off, jnp.asarray(pos), panel_dtype=jdt,
                     interpret=True, jj0=16, r=16)
        tp = strip_panel_pivots(torch.from_numpy(slab), off, torch.from_numpy(pos), tdt,
                                jj0=16, r=16)
        for name, a, b in zip(("piv", "pos", "glist"), jp, tp):
            np.testing.assert_array_equal(_np(a), b.numpy(), err_msg=f"{name} off={off}")


def test_strip_pivots_quant16_tie_and_sentinel():
    """quant16 coarsens near-ties to the lowest position, the exact search
    takes the true max (test_panel_fused.py:78-98); dead rows (2^31-1)
    never pivot and keep their sentinel — all as the JAX kernel does."""
    m, r = 128, 8
    rng = np.random.default_rng(7)
    a = (0.001 + rng.uniform(0, 1e-4, (m, r))).astype(np.float32)
    a[5, 0] = 1.0
    a[100, 0] = np.float32(1.0 + 2.0**-9)
    pos = np.arange(m, dtype=np.int32)
    pos[[7, 70]] = SENT
    a[70, 0] = 50.0  # a dead row with the largest value
    for q16 in (True, False):
        jp = j_strip(jnp.asarray(a), 0, jnp.asarray(pos), panel_dtype=jnp.float32,
                     interpret=True, _quant16=q16)
        tp = strip_panel_pivots(torch.from_numpy(a), 0, torch.from_numpy(pos),
                                torch.float32, quant16=q16)
        for x, y in zip(jp, tp):
            np.testing.assert_array_equal(_np(x), y.numpy())
        assert int(tp[0][0]) == (5 if q16 else 100)
        assert int(tp[1][70]) == SENT and int(tp[1][7]) == SENT


# ---------------------------------------------------------------- kernel 2

@pytest.mark.parametrize("zero_pivot", [False, True])
def test_rowblock_assemble_matches_jax(zero_pivot):
    """rowblock / uinv within rtol 2e-4 of rowblock_assemble(interpret);
    info exact — 2 when the second pivot is made exactly zero."""
    rng = np.random.default_rng(3)
    m, bc, r, jj0 = 256, 128, 16, 16
    slab = rng.standard_normal((m, bc)).astype(np.float32)
    glist = rng.permutation(m)[:r].astype(np.int32)
    if zero_pivot:
        slab[glist[1], jj0:jj0 + r] = slab[glist[0], jj0:jj0 + r]
    jrb, jui, jinfo = j_rowblock(jnp.asarray(slab), jnp.asarray(glist), jj0, interpret=True)
    trb, tui, tinfo = rowblock_assemble(torch.from_numpy(slab), torch.from_numpy(glist), jj0)
    assert int(tinfo) == int(jinfo) == (2 if zero_pivot else 0)
    if not zero_pivot:  # the refactor of a singular block is not comparable
        np.testing.assert_allclose(trb.numpy(), _np(jrb), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tui.numpy(), _np(jui), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(trb.numpy()[:, :jj0], slab[glist][:, :jj0])


# ---------------------------------------------------------------- kernel 3

@pytest.mark.parametrize("gemm_bf16", [False, True])
def test_panel_update_matches_jax(gemm_bf16):
    """panel_apply_update_trim vs the JAX kernel (interpret): rtol 1e-5 on
    the updated columns (fp32 sums in another order); frozen rows and the
    columns left of the panel bit-identical."""
    rng = np.random.default_rng(5)
    m, bc, r = 256, 128, 8
    for j0, jj0 in ((16, 16), (0, 0), (120, 120)):
        slab = rng.standard_normal((m, bc)).astype(np.float32)
        pos = rng.permutation(m).astype(np.int32)
        rowblock = rng.standard_normal((r, bc)).astype(np.float32)
        uinv = np.triu(rng.standard_normal((r, r))).astype(np.float32)
        jout = _np(j_update(jnp.asarray(slab), jnp.asarray(pos), jnp.asarray(rowblock),
                            jnp.asarray(uinv), j0, jj0, rb=128, gemm_bf16=gemm_bf16,
                            interpret=True))
        t = torch.from_numpy(slab.copy())
        panel_apply_update_trim(t, torch.from_numpy(pos), torch.from_numpy(rowblock),
                                torch.from_numpy(uinv), j0, jj0, gemm_bf16=gemm_bf16)
        np.testing.assert_allclose(t.numpy(), jout, rtol=1e-5, atol=1e-5)
        frozen = pos < j0 + r
        np.testing.assert_array_equal(t.numpy()[frozen], slab[frozen])
        np.testing.assert_array_equal(t.numpy()[:, :jj0], slab[:, :jj0])


# ---------------------------------------------------------------- kernel 4

def _composed_exchange(rng, n, k, nr):
    """glist/dests of a block column whose pivots are sequential swaps
    (the driver's composed map): chains bottom out in the band."""
    perm = np.arange(n)
    for j in range(nr):
        p = rng.integers(k + j, n) if rng.random() < 0.7 else k + j
        perm[[k + j, p]] = perm[[p, k + j]]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return perm[k:k + nr].astype(np.int32), inv[k:k + nr].astype(np.int32)


def test_rows_exchange_bitexact_vs_jax():
    rng = np.random.default_rng(40)
    n, w, k, nr = 256, 128, 64, 32
    a = rng.standard_normal((n, w)).astype(np.float32)
    glist, dests = _composed_exchange(rng, n, k, nr)
    ja, jpiv = j_rows_exchange(jnp.asarray(a), k, jnp.asarray(glist), jnp.asarray(dests),
                               interpret=True)
    ja = _np(ja).copy()
    ja[k:k + nr] = _np(jpiv)
    t = torch.from_numpy(a.copy())
    tpiv = rows_exchange(t, k, torch.from_numpy(glist), torch.from_numpy(dests))
    np.testing.assert_array_equal(tpiv.numpy(), _np(jpiv))
    t[k:k + nr] = tpiv
    np.testing.assert_array_equal(t.numpy(), ja)
    # and the result is the row permutation the swaps describe
    np.testing.assert_array_equal(np.sort(t.numpy()[:, 0]), np.sort(a[:, 0]))


# ---------------------------------------------------------------- kernel 5

def test_tri_inv_leaf_matches_jax():
    """Plain leaf inverse within 1e-5 of the Pallas leaf (interpret) and of
    blas3.unit_lower_inv (a triangular solve).  Not bitwise: the JAX CPU
    backend contracts ``li - mult * lrow`` into one FMA, while the plain
    version and the CUDA kernel round the product and the difference
    separately (bit-identical to each other on the card)."""
    rng = np.random.default_rng(11)
    s = 64
    l = np.tril(rng.uniform(-0.5, 0.5, (s, s)), -1).astype(np.float32)
    l += np.diag(rng.uniform(1, 2, s)).astype(np.float32)  # ignored (unit)
    t = tri_inv_leaves(torch.from_numpy(l), [(0, s)]).numpy()
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        jp = _np(unit_lower_inv_pallas(jnp.asarray(l)))
    np.testing.assert_allclose(t, jp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t, _np(JB.unit_lower_inv(jnp.asarray(l))), rtol=1e-5,
                               atol=1e-5)


def test_unit_lower_inv_blocked_matches_jax():
    """Recursive blocked inverse (leaves through kernel 5's plain version)
    vs the JAX package's on the jnp path: rtol 1e-5; plus the plain inverses."""
    rng = np.random.default_rng(12)
    n = 320
    l = np.tril(rng.uniform(-0.5, 0.5, (n, n)) / 8, -1).astype(np.float32)
    t = unit_lower_inv_blocked(torch.from_numpy(l), base=64).numpy()
    j = _np(JB.unit_lower_inv_blocked(jnp.asarray(l), base=64))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert _leaves(n, 64) == [(0, 64), (64, 64), (128, 64), (192, 64), (256, 64)]
    np.testing.assert_allclose(unit_lower_inv(torch.from_numpy(l)).numpy(),
                               _np(JB.unit_lower_inv(jnp.asarray(l))), rtol=1e-5, atol=1e-6)
    u = np.triu(rng.uniform(-0.5, 0.5, (64, 64))) + 4 * np.eye(64)
    u = u.astype(np.float32)
    np.testing.assert_allclose(upper_inv(torch.from_numpy(u)).numpy(),
                               _np(JB.upper_inv(jnp.asarray(u))), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- kernel 6

@pytest.mark.parametrize("jpol,tdt", [(J_BF16, torch.bfloat16), (J_F32, torch.float32)])
def test_trailing_gemm_sub_matches_jax(jpol, tdt):
    """a[ko:, ko:ko+ncols] -= l21 @ u12 vs blas3.trailing_update: rtol 1e-5
    (fp32 accumulation in another order); everything else untouched."""
    rng = np.random.default_rng(13)
    n, ko, kk, ncols = 384, 128, 64, 192
    a = rng.standard_normal((n, n)).astype(np.float32)
    l21 = rng.standard_normal((n - ko, kk)).astype(np.float32)
    u12 = rng.standard_normal((kk, ncols)).astype(np.float32)
    exp = _np(JB.trailing_update(jnp.asarray(a[ko:, ko:ko + ncols]), jnp.asarray(l21),
                                 jnp.asarray(u12), jpol))
    t = torch.from_numpy(a.copy())
    trailing_gemm_sub(t, torch.from_numpy(l21).to(tdt), torch.from_numpy(u12).to(tdt), ko,
                      ncols=ncols)
    np.testing.assert_allclose(t.numpy()[ko:, ko:ko + ncols], exp, rtol=1e-5, atol=1e-4)
    out = t.numpy().copy()
    out[ko:, ko:ko + ncols] = a[ko:, ko:ko + ncols]
    np.testing.assert_array_equal(out, a)


def test_wrappers_count_plain_calls_on_cpu():
    """On CPU tensors every wrapper runs its plain version (and counts it),
    never a kernel."""
    _lib.reset_counts()
    a = torch.eye(16)
    trailing_gemm_sub(a, torch.zeros(8, 4), torch.zeros(4, 8), 8)
    tri_inv_leaves(a, [(0, 16)])
    assert _lib.plain_calls["trailing_sub"] == 1 and _lib.plain_calls["tri_inv"] == 1
    assert not any(_lib.launches.values())
    with pytest.raises(ValueError):
        _lib.on_cuda(a, torch.empty(1, device="meta"))
