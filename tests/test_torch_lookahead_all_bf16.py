"""Port parity for the lookahead driver under ALL_BF16 (bf16 working
storage: kernel 13's bf16-C instance), against the JAX package's lookahead
driver in Pallas interpret mode, in a file of its own so that the two
interpret-mode drivers of tests/test_torch_lookahead.py and this one run on
separate workers."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas.tpu as pltpu  # noqa: E402

import mpf_tpu  # noqa: E402
import mpf_tpu.config as cfg  # noqa: E402
import mpf_tpu.models.mpf as M  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
from mpf_tpu_torch.convert import result_to_numpy  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization, within_bf16_ulp  # noqa: E402


def test_lookahead_all_bf16_hpl_matches_jax(monkeypatch):
    """HPL-AI, ALL_BF16, n = 384, r = 32, block 128 (kernel 13 once): ipiv
    and perm exact, LU within one bf16 ulp entry by entry
    (``utils/oracle.within_bf16_ulp``), the oracle at 5e-2."""
    n = 384
    a = matgen.hpl_ai_matrix(n, seed=0).astype(np.float32)
    monkeypatch.setattr(M, "_PAD_QUANTUM", 128)
    monkeypatch.setattr(M, "_FUSED_RB", 128)
    monkeypatch.setattr(cfg, "_USE_PALLAS", "1")
    monkeypatch.setenv("MPF_FORCE_KERNELS", "1")
    with pltpu.force_tpu_interpret_mode():
        j = jax.tree.map(np.asarray, M.mpf_factorize_traced(
            jnp.asarray(a, dtype=jnp.bfloat16), r=32, policy=mpf_tpu.ALL_BF16, block=128,
            lookahead=True))
    _lib.reset_counts()
    t = result_to_numpy(T.mpf_factorize(torch.from_numpy(a), r=32, policy=T.ALL_BF16,
                                        block=128, lookahead=True))
    assert _lib.plain_calls["gemmx"] == 1 and not any(_lib.launches.values())
    np.testing.assert_array_equal(t.ipiv, j.ipiv)
    np.testing.assert_array_equal(t.perm, j.perm)
    lu_j = np.asarray(j.lu, np.float32)
    assert within_bf16_ulp(torch.from_numpy(t.lu), torch.from_numpy(lu_j)).ok
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=5e-2).ok
