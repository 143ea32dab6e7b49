"""Kernel 5's schedule on the CPU.  The card's kernel (csrc/tri_inv.cu) runs
each column of a leaf inverse as its own forward substitution: column c
starts as the identity's, and for j = c, c + 1, ... the rows below j take
X[i, c] = sub_mul(X[i, c], l[i, j], X[j, c]).  A plain mirror of that
schedule, a column at a time through ``_lib.sub_mul``, must give the bits
of the Gauss-Jordan plain version (``blas3.tri_inv_leaves_plain``, what
the kernel is held to bitwise on the card), fp32 and bf16, and agree with
the JAX package's Pallas kernel in interpret mode within 1e-5 (the
tolerance of ``test_torch_kernels.py::test_tri_inv_leaf_matches_jax``).
Inputs from numpy with fixed seeds."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops.panel_pallas import unit_lower_inv_pallas  # noqa: E402

from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.ops.blas3 import tri_inv_leaves, tri_inv_leaves_plain  # noqa: E402

SIZES = [1, 2, 17, 64, 128]
DTYPES = [torch.float32, torch.bfloat16]


def tri_inv_by_columns(l: torch.Tensor, o: int, s: int) -> torch.Tensor:
    """The inverse of the unit-lower leaf (o, s) of ``l`` in the kernel's
    order: one column at a time, each a forward substitution in ascending
    j, every row below j updated at step j."""
    blk = l[o:o + s, o:o + s]
    x = torch.zeros((s, s), dtype=l.dtype)
    for c in range(s):
        col = torch.zeros(s, dtype=l.dtype)
        col[c] = 1
        for j in range(c, s - 1):
            col[j + 1:] = _lib.sub_mul(col[j + 1:], blk[j + 1:, j], col[j])
        x[:, c] = col
    return x


def _leaf_matrix(s: int, dtype, off: int = 3) -> torch.Tensor:
    """A matrix with one unit-lower leaf of size s at diagonal offset off,
    its entries uniform in [-0.5, 0.5) (the diagonal random too: ignored)."""
    rng = np.random.default_rng(s)
    n = s + off + 2
    a = rng.uniform(-0.5, 0.5, (n, n)).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", SIZES)
def test_column_schedule_is_bitwise_the_plain_version(s, dtype):
    l = _leaf_matrix(s, dtype)
    want = tri_inv_leaves_plain(l, [(3, s)])[3:3 + s, 3:3 + s]
    got = tri_inv_by_columns(l, 3, s)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    # and the wrapper on CPU tensors is the plain version
    assert torch.equal(tri_inv_leaves(l, [(3, s)])[3:3 + s, 3:3 + s], want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", SIZES)
def test_column_schedule_matches_jax_kernel(s, dtype):
    """Against `mpf_tpu/ops/panel_pallas.py:_tri_inv_kernel` (interpret mode)
    on the same leaf in the same dtype: within 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    l = _leaf_matrix(s, dtype)
    leaf = l[3:3 + s, 3:3 + s].float().numpy()
    jl = jnp.asarray(leaf).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        jp = np.asarray(unit_lower_inv_pallas(jl).astype(jnp.float32))
    got = tri_inv_by_columns(l, 3, s).float().numpy()
    np.testing.assert_allclose(got, jp, rtol=1e-5, atol=1e-5)
