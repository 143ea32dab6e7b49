"""The deferred-exchange slice against the JAX package as a whole: one
JAX ``mpf_factorize_traced(defer=2)`` run with its Pallas kernels in
interpret mode (set up as tests/test_defer.py:24-36) beside the port's
``mpf_factorize(defer=2)``, MPF_BF16, n = 384, r = 32, block 128, on
``random_dense(384, seed=3)``.  In a file of its own so that xdist gives
the ~30 s interpret run a worker to itself."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mpf_tpu  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization  # noqa: E402

#: the first pivot at which the port's classic loop and the JAX package's
#: classic loop (fused path, interpret mode) part on this input
CLASSIC_AGREE = 87


def test_defer_vs_jax_deferred_driver_interpret(monkeypatch):
    """Held exact: ipiv and perm up to pivot 87, where the two classic
    loops first part on this input (inside the first block column: fp32
    sums in another order, then bf16 rounding of L21, tip the quant16
    search between two near-equal pivots, as
    tests/test_torch_mpf.py:251-265 sets out).  The JAX deferred run
    equals its classic run, and the port's deferred run the port's classic
    run, so the deferral parts the two packages nowhere else.  Both
    factorizations pass the MPF_BF16 oracle (1e-3), their row maps are
    permutations, and the port launches nothing on the CPU."""
    import jax.experimental.pallas.tpu as pltpu
    import mpf_tpu.config as cfg
    import mpf_tpu.models.mpf as M

    monkeypatch.setattr(M, "_PAD_QUANTUM", 128)
    monkeypatch.setattr(M, "_FUSED_RB", 128)
    monkeypatch.setattr(cfg, "_USE_PALLAS", "1")
    monkeypatch.setenv("MPF_FORCE_KERNELS", "1")
    n = 384
    a = matgen.random_dense(n, seed=3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j = jax.tree.map(np.asarray, M.mpf_factorize_traced(
            jnp.asarray(a), r=32, policy=mpf_tpu.MPF_BF16, block=128, defer=2))
    _lib.reset_counts()
    t = T.mpf_factorize(torch.from_numpy(a), r=32, block=128, defer=2)
    assert _lib.plain_calls["flush_overflow"] == 2 and _lib.plain_calls["copy_rows"] == 3
    assert not any(_lib.launches.values())
    c = T.mpf_factorize(torch.from_numpy(a), r=32, block=128)
    assert torch.equal(t.ipiv, c.ipiv) and torch.equal(t.lu, c.lu)
    tn = (t.lu.numpy(), t.ipiv.numpy(), t.perm.numpy())
    np.testing.assert_array_equal(tn[1][:CLASSIC_AGREE], j.ipiv[:CLASSIC_AGREE])
    np.testing.assert_array_equal(tn[2][:CLASSIC_AGREE], j.perm[:CLASSIC_AGREE])
    assert tn[1][CLASSIC_AGREE] != j.ipiv[CLASSIC_AGREE]
    for lu, ipiv, perm in (tn, (j.lu, j.ipiv, j.perm)):
        assert check_factorization(a, lu, ipiv, nbe_tol=1e-3).ok
        np.testing.assert_array_equal(np.sort(perm), np.arange(n))
