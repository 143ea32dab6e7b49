"""Port parity for the pair-layout (n/2, 2, n) driver: each pair op's
plain version (kernels 15a-15d, ``rows_exchange3`` and ``trailing_sub3``)
against the JAX package's ``pair3d`` / ``rows_exchange3`` functions in
interpret mode (each JAX call jitted with the ops that read its result,
see :func:`_jax`); the 3D driver bitwise against the port's own 2D classic
loop (the sizes of tests/test_pair3d.py); the gate and shape errors, the
``pairs=`` generators, donation, the plain-call counts; and that no
reference cycle keeps a factored matrix alive.  Inputs come from numpy
with fixed seeds; each test states its tolerance.  No kernel launches on
the CPU."""

import gc
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops import pair3d as jp  # noqa: E402
from mpf_tpu.ops.exchange import rows_exchange3 as j_rows_exchange3  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
from mpf_tpu_torch.models import mpf as TM  # noqa: E402
from mpf_tpu_torch.ops import _lib, pair3d  # noqa: E402
from mpf_tpu_torch.ops.blas3 import unit_lower_inv_blocked  # noqa: E402
from mpf_tpu_torch.ops.exchange import rows_exchange3  # noqa: E402
from mpf_tpu_torch.utils import matgen as tmatgen  # noqa: E402
from mpf_tpu_torch.utils.oracle import sum_slack, within_ulp  # noqa: E402

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_POL = {torch.float32: T.MPF_BF16, torch.bfloat16: T.ALL_BF16}
N, R, BLOCK = 384, 32, 128      # tests/test_pair3d.py's sizes
NK = 256                         # the kernel tests' matrix


def _pair(a_np, tdt):
    """The same (n/2, 2, n) values as a torch tensor of ``tdt`` and a jax
    array that shares no memory with it (the ops write in place)."""
    n = a_np.shape[0]
    t = torch.from_numpy(a_np).to(tdt).view(n // 2, 2, n)
    return t, jnp.asarray(t.float().numpy().copy()).astype(_JDT[tdt])


def _jax(fn, *args):
    """``fn(*args)`` with every array output cast to fp32, as one jitted
    computation, returned as numpy arrays.  Interpret-mode kernels run
    their bodies through host callbacks that dispatch JAX ops of their
    own; an eager op dispatched from the test while such a kernel runs
    can queue ahead of them and deadlock (seen under load), so nothing
    is dispatched until the whole computation is done."""
    out = jax.jit(lambda *a: jax.tree.map(lambda x: x.astype(jnp.float32), fn(*a)))(*args)
    return jax.tree.map(np.array, out)


def _stage(tdt, k=0):
    """A block column's pivot rows and destinations (``glist``, ``dests``)
    and its finished row block, from the port's fused panel stage at block
    column ``k`` of the uniform matrix (n = 256, r = 32, block 128), with
    the matrix after the panel work."""
    a = torch.from_numpy(matgen.random_dense(NK, seed=3)).to(tdt)
    ipiv = torch.arange(1, NK + 1, dtype=torch.int32)
    info = torch.zeros((), dtype=torch.int32)
    _, stage = TM._fused_panel_stage(a, k, BLOCK, R, _POL[tdt], ipiv, info)
    return a, stage


# ------------------------------------------------------- the ops vs JAX

@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_slab_extract_writeback_match_jax(tdt):
    """Exact: the (128, 128) slab at rows [128, 256), columns [128, 256)
    copied out, and a new slab written back at rows [128, 256), columns
    [0, 128), as the JAX kernels (interpret) copy them; one plain call
    each, nothing launched."""
    rng = np.random.default_rng(1)
    t3, j3 = _pair(rng.uniform(0, 9.9, (NK, NK)).astype(np.float32), tdt)
    sub = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(tdt)
    _lib.reset_counts()
    got = pair3d.slab_extract(t3, 128, 128, 128, 128)
    assert got.is_contiguous() and got.shape == (128, 128)
    np.testing.assert_array_equal(got.float().numpy(), _jax(
        lambda x: jp.slab_extract(x, 128, 128, 128, 128, interpret=True), j3))
    assert pair3d.slab_writeback(t3, sub, 128, 0) is t3
    ref = _jax(lambda x, y: jp.slab_writeback(x, y, 128, 0, interpret=True), j3,
               jnp.asarray(sub.float().numpy()).astype(_JDT[tdt]))
    np.testing.assert_array_equal(t3.float().numpy(), ref)
    assert _lib.plain_calls["slab_extract"] == _lib.plain_calls["slab_writeback"] == 1
    assert not any(_lib.launches.values())


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_rows_exchange3_band_write_match_jax(tdt):
    """Exact: block column 0's exchange (``glist``/``dests`` of a real
    block column, rows moving out of the band) on the pair matrix, then
    the band write, against JAX's ``rows_exchange3`` and
    ``band_write_rows`` (interpret).  The port's pivot rows are in the
    working dtype, JAX's its fp32 staging: the same values."""
    a, stage = _stage(tdt)
    glist, dests = stage[2], stage[3]
    assert int(((dests < 0) | (dests >= BLOCK)).sum()) > 0     # rows leave the band
    t3 = a.clone().view(NK // 2, 2, NK)
    j3 = jnp.asarray(a.float().numpy()).astype(_JDT[tdt]).reshape(NK // 2, 2, NK)
    _lib.reset_counts()
    piv = rows_exchange3(t3, 0, glist, dests)

    def exchange_then_band_write(x, g, d):
        x, p = j_rows_exchange3(x, 0, g, d, interpret=True)
        return x, p, jp.band_write_rows(x, p, 0, interpret=True)
    jx, jpiv, jband = _jax(exchange_then_band_write, j3, jnp.asarray(glist.numpy()),
                           jnp.asarray(dests.numpy()))
    assert piv.dtype == tdt and piv.shape == (BLOCK, NK)
    np.testing.assert_array_equal(piv.float().numpy(), jpiv.reshape(BLOCK, NK))
    np.testing.assert_array_equal(t3.float().numpy(), jx)
    assert pair3d.band_write_rows(t3, piv, 0) is t3
    np.testing.assert_array_equal(t3.float().numpy(), jband)
    assert _lib.plain_calls["rows_exchange"] == _lib.plain_calls["band_write"] == 1
    assert not any(_lib.launches.values())


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_u12_transform_matches_jax(tdt):
    """U12 := L11^{-1} A12 in place at rows [0, 128), columns [128, 256),
    with a real block column's L11^{-1}, against JAX's ``u12_transform``
    (interpret, HIGHEST: an fp32 dot).  Both are fp32 sums of the same
    products in other orders, rounded once: within one ulp of the working
    dtype plus ``sum_slack``; everything outside the block exact."""
    _, stage = _stage(tdt)
    linv = unit_lower_inv_blocked(stage[4], base=R)
    rng = np.random.default_rng(4)
    t3, j3 = _pair(rng.uniform(0, 9.9, (NK, NK)).astype(np.float32), tdt)
    a12 = pair3d.as_matrix(t3)[:BLOCK, BLOCK:].clone()
    before = t3.clone()
    _lib.reset_counts()
    pair3d.u12_transform(t3, linv, 0, BLOCK, NK - BLOCK)
    assert _lib.plain_calls["u12_inplace"] == 1 and not any(_lib.launches.values())
    ref = _jax(lambda x, li: jp.u12_transform(x, li, 0, BLOCK, NK - BLOCK,
                                              jax.lax.Precision.HIGHEST, interpret=True),
               j3, jnp.asarray(linv.float().numpy()).astype(_JDT[tdt]))
    got = t3.float().numpy().reshape(NK, NK)
    ref = ref.reshape(NK, NK)
    rep = within_ulp(torch.from_numpy(got[:BLOCK, BLOCK:]), torch.from_numpy(ref[:BLOCK, BLOCK:]),
                     sum_slack(torch.zeros(()), linv, a12), tdt)
    assert rep.ok, rep
    outside = np.ones((NK, NK), bool)
    outside[:BLOCK, BLOCK:] = False
    np.testing.assert_array_equal(got[outside], before.float().numpy().reshape(NK, NK)[outside])
    np.testing.assert_array_equal(ref[outside], got[outside])


@pytest.mark.parametrize("tdt,gd", [(torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)],
                         ids=["fp32_bf16_operands", "fp32", "bf16"])
def test_trailing_sub3_matches_jax(tdt, gd):
    """A[128:, 128:] -= L21 @ U12 on the pair matrix (K = 128) against
    JAX's ``trailing_sub3`` (interpret) on the same operands: fp32 sums of
    the same (exact) products in other orders, so within one ulp of the
    working dtype plus ``sum_slack``; the rest of the matrix exact.  Runs
    kernel 6's plain version, counted as ``trailing_sub``."""
    rng = np.random.default_rng(5)
    t3, j3 = _pair(rng.uniform(0, 9.9, (NK, NK)).astype(np.float32), tdt)
    l21 = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(gd)
    u12 = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(gd)
    c = pair3d.as_matrix(t3)[128:, 128:].clone()
    _lib.reset_counts()
    assert pair3d.trailing_sub3(t3, l21, u12, 128) is t3
    assert _lib.plain_calls["trailing_sub"] == 1 and not any(_lib.launches.values())
    jg = _JDT[gd]
    ref = _jax(lambda x, l, u: jp.trailing_sub3(x, l, u, 128, interpret=True), j3,
               jnp.asarray(l21.float().numpy()).astype(jg).reshape(64, 2, 128),
               jnp.asarray(u12.float().numpy()).astype(jg).reshape(64, 2, 128)).reshape(NK, NK)
    got = t3.float().numpy().reshape(NK, NK)
    rep = within_ulp(torch.from_numpy(got[128:, 128:]), torch.from_numpy(ref[128:, 128:]),
                     sum_slack(c, l21, u12), tdt)
    assert rep.ok, rep
    np.testing.assert_array_equal(got[:128], ref[:128])
    np.testing.assert_array_equal(got[:, :128], ref[:, :128])


# --------------------------------------------- the driver vs the 2D loop

@pytest.mark.parametrize("policy", [T.MPF_BF16, T.ALL_BF16], ids=["mpf_bf16", "all_bf16"])
@pytest.mark.parametrize("corpus", ["uniform", "hpl"])
def test_pair3d_bitwise_vs_2d(policy, corpus):
    """Bitwise: ipiv, perm, lu (as its (n, n) view) and info of the 3D
    driver equal the port's 2D classic loop on the same matrix (n = 384,
    r = 32, block 128).  On the CPU the plain U12 is the 2D loop's
    product, so nothing parts them.  The factors come back (n/2, 2, n)."""
    gen = matgen.random_dense if corpus == "uniform" else matgen.hpl_ai_matrix
    a = torch.from_numpy(gen(N, seed=5).astype(np.float32))
    r2 = T.mpf_factorize(a, r=R, block=BLOCK, policy=policy)
    r3 = T.mpf_factorize(a.view(N // 2, 2, N), r=R, block=BLOCK, policy=policy)
    assert r3.lu.shape == (N // 2, 2, N) and r3.lu.dtype == policy.working
    assert torch.equal(r3.ipiv, r2.ipiv) and torch.equal(r3.perm, r2.perm)
    assert torch.equal(r3.lu.view(N, N), r2.lu) and int(r3.info) == int(r2.info) == 0


@pytest.mark.parametrize("policy", [T.MPF_BF16, T.ALL_BF16], ids=["mpf_bf16", "all_bf16"])
def test_pair3d_plain_calls(policy):
    """Per block column one extract, one writeback, one exchange and one
    band write; per block column but the last one U12, one kernel-5 call
    and one trailing GEMM; the panel ops as in the 2D loop (under ALL_BF16
    kernel 12's update on every panel but a block column's last).  Nothing
    launches on the CPU."""
    a = torch.from_numpy(matgen.hpl_ai_matrix(N, seed=2)).view(N // 2, 2, N)
    _lib.reset_counts()
    T.mpf_factorize(a, r=R, block=BLOCK, policy=policy)
    cols, panels = N // BLOCK, N // R
    want = dict(slab_extract=cols, slab_writeback=cols, rows_exchange=cols, band_write=cols,
                u12_inplace=cols - 1, tri_inv=cols - 1, trailing_sub=cols - 1,
                strip_pivots=panels, rowblock=panels)
    if policy is T.ALL_BF16:
        want.update(l21_trim=panels, upd_wide=panels - cols)
    else:
        want["panel_update"] = panels
    assert {k: v for k, v in _lib.plain_calls.items() if v} == want
    assert not any(_lib.launches.values())


def test_pair3d_entries_and_donation():
    """``make_mpf(donate=True)`` factors a contiguous working-dtype 3D
    tensor in place (``result.lu`` is the tensor); ``donate=False`` and a
    numpy input leave the input alone; ``mpf_factorize_inplace`` factors
    in place too.  All equal the 2D loop's factors."""
    a = torch.from_numpy(matgen.random_dense(N, seed=8))
    ref = T.mpf_factorize(a, r=R, block=BLOCK, policy=T.ALL_BF16)
    a3 = a.to(torch.bfloat16).view(N // 2, 2, N).clone()
    res = T.make_mpf(N, r=R, block=BLOCK, policy=T.ALL_BF16)(a3)
    assert res.lu is a3 and torch.equal(a3.view(N, N), ref.lu)
    assert torch.equal(res.ipiv, ref.ipiv) and torch.equal(res.perm, ref.perm)
    b3 = a.to(torch.bfloat16).view(N // 2, 2, N).clone()
    keep = b3.clone()
    res = T.make_mpf(N, r=R, block=BLOCK, policy=T.ALL_BF16, donate=False)(b3)
    assert torch.equal(b3, keep) and torch.equal(res.lu.view(N, N), ref.lu)
    res = T.make_mpf(N, r=R, block=BLOCK, policy=T.ALL_BF16, device="cpu")(
        a.numpy().reshape(N // 2, 2, N))
    assert res.lu.shape == (N // 2, 2, N) and torch.equal(res.ipiv, ref.ipiv)
    c3 = a.to(torch.bfloat16).view(N // 2, 2, N).clone()
    res = TM.mpf_factorize_inplace(c3, r=R, block=BLOCK, policy=T.ALL_BF16)
    assert res.lu is c3 and torch.equal(c3.view(N, N), ref.lu)


# ------------------------------------------------------ gate and shapes

def _raises(fn, match):
    with pytest.raises(ValueError, match=match):
        fn()


@pytest.mark.parametrize("case", ["bad_shape", "pivot_false", "mpf_fp16", "lookahead",
                                  "defer", "superblock", "split_exchange", "ragged_block",
                                  "panel_kernel", "make_mpf_shape"])
def test_pair3d_gate_and_shape_errors(case, monkeypatch):
    """JAX's two messages (`mpf.py:984-1014`): a 3D shape that is not
    (n/2, 2, n) raises "expected (n/2, 2, n) pair layout"; a request off
    the fused path raises "pair-layout (3D) input requires the fused kernel
    path" — ``pivot=False`` (the ``test_pair3d_requires_fused_path``
    case), MPF_FP16 (its panel cast saturates), lookahead, the deferred
    exchange, a superblock, ``MPF_XCHG=split``, n not a multiple of block
    and a ``panel_kernel``.  A factorizer of another size names the pair
    layout it takes."""
    z = torch.zeros(N // 2, 2, N)
    fused_path = "pair-layout \\(3D\\) input requires the fused kernel path"
    run = {
        "bad_shape": (lambda: T.mpf_factorize(torch.zeros(100, 2, 128), r=R, block=BLOCK),
                      "expected \\(n/2, 2, n\\) pair layout"),
        "pivot_false": (lambda: T.mpf_factorize(torch.zeros(64, 2, 128), r=R, block=BLOCK,
                                                pivot=False), fused_path),
        "mpf_fp16": (lambda: T.mpf_factorize(z, r=R, block=BLOCK, policy=T.MPF_FP16),
                     fused_path),
        "lookahead": (lambda: T.mpf_factorize(z, r=R, block=BLOCK, lookahead=True), fused_path),
        "defer": (lambda: T.mpf_factorize(z, r=R, block=BLOCK, defer=2), fused_path),
        "superblock": (lambda: T.mpf_factorize(torch.zeros(256, 2, 512), r=R, block=BLOCK,
                                               super_block=256), fused_path),
        "split_exchange": (lambda: T.mpf_factorize(z, r=R, block=BLOCK), fused_path),
        "ragged_block": (lambda: T.mpf_factorize(z, r=R, block=256), fused_path),
        "panel_kernel": (lambda: T.make_mpf(N, r=R, block=BLOCK, panel_kernel=print)(z),
                         fused_path),
        "make_mpf_shape": (lambda: T.make_mpf(N, r=R, block=BLOCK)(torch.zeros(N, 2, N)),
                           "pair layout \\(192, 2, 384\\)"),
    }
    if case == "split_exchange":
        monkeypatch.setenv("MPF_XCHG", "split")
    _lib.reset_counts()
    _raises(*run[case])
    assert not any(_lib.plain_calls.values())


# ------------------------------------------------------------ generators

@pytest.mark.parametrize("gen", [tmatgen.hpl_ai_matrix_device, tmatgen.random_dense_device],
                         ids=["hpl_ai", "uniform"])
def test_pair_generators(gen):
    """``pairs=True`` is the (n/2, 2, n) view of the 2D matrix, bit for bit
    (`test_pair_generators_match_2d`); with ``ext_rows`` or an odd n it
    raises."""
    a2 = gen(256, seed=3, device="cpu")
    a3 = gen(256, seed=3, device="cpu", pairs=True)
    assert a3.shape == (128, 2, 256) and torch.equal(a3.reshape(256, 256), a2)
    with pytest.raises(ValueError, match="pair layout"):
        gen(256, seed=3, device="cpu", pairs=True, ext_rows=128)
    with pytest.raises(ValueError, match="pair layout"):
        gen(255, seed=3, device="cpu", pairs=True)


# ------------------------------------------------ no matrix left behind

@pytest.mark.parametrize("driver", ["classic", "pairs", "lookahead", "defer", "superblock",
                                    "masked"])
def test_factored_matrix_is_freed_without_gc(driver):
    """Dropping the result and the input frees the matrix at once, with
    Python's cyclic collector off: no reference cycle holds it.  (The
    recursive inverse of ``unit_lower_inv_blocked`` was a closure that
    called itself, a cycle that kept a view of the whole matrix alive
    until the collector ran: on the card 5.5-6.45 GiB of device memory at
    n = 65536.)"""
    n = 512
    kw = dict(classic={}, pairs={}, lookahead=dict(lookahead=True), defer=dict(defer=2),
              superblock=dict(super_block=256), masked=dict(block=48))[driver]
    a = torch.from_numpy(matgen.hpl_ai_matrix(n, seed=1)).to(torch.bfloat16)
    if driver == "pairs":
        a = a.view(n // 2, 2, n)
    fac = T.make_mpf(n, r=R, policy=T.ALL_BF16, **{"block": BLOCK, **kw})
    ref = weakref.ref(a)
    gc.collect()
    gc.disable()
    try:
        res = fac(a)
        assert res.lu.data_ptr() == a.data_ptr() or driver == "defer"
        del res, a
        assert ref() is None
    finally:
        gc.enable()
