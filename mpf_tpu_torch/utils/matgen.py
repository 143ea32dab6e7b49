"""Host matrix generators (numpy only), copied from `mpf_tpu/utils/matgen.py`.

* :func:`generate_corpus` replicates the reference's `matrix_generator.cpp`
  (glibc ``rand()`` consumption order, size schedule, value distribution)
  bit for bit.
* :func:`random_dense`, :func:`hpl_ai_matrix`, :func:`random_conditioned`
  are the fast seeded generators the benchmarks and tests use.

The same seed gives the same matrix as the JAX package's generators, so the
two packages can be compared on identical inputs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from mpf_tpu_torch.utils.glibc_rand import GlibcRand


def corpus_sizes(max_size: int, step: int = 2, mode: str = "exp") -> List[int]:
    """The reference's size schedule (`matrix_generator.cpp:55-78`)."""
    if mode not in ("exp", "lin"):
        raise ValueError(f"mode must be 'exp' or 'lin', got {mode!r}")
    if step <= 0 or (mode == "exp" and step < 2):
        raise ValueError(f"step must be >= 2 for mode='exp' (got {step})")
    sizes = []
    size = 2
    while size <= max_size:
        sizes.append(size)
        size = size * step if mode == "exp" else size + step
    return sizes


def generate_matrix(n: int, rng: GlibcRand, sparsity: float = 0.0) -> np.ndarray:
    """One (n, n) fp64 matrix with the reference's element semantics."""
    a = np.empty((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            if sparsity > 0.0 and rng.uniform() < sparsity:
                a[i, j] = 0.0
            else:
                a[i, j] = rng.ref_value()
    return a


def generate_corpus(
    max_size: int, step: int = 2, mode: str = "exp", sparsity: float = 0.0, seed: int = 1
) -> List[np.ndarray]:
    """Full corpus, PRNG-consumption-order-identical to the reference
    generator run with the same arguments (unseeded C = ``seed=1``)."""
    if not (0.0 <= sparsity < 1.0):
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    rng = GlibcRand(seed)
    return [generate_matrix(n, rng, sparsity) for n in corpus_sizes(max_size, step, mode)]


def random_dense(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Uniform [0, 9.9] dense matrix — the reference corpus's distribution
    (`matrix_generator.cpp:66`); pivots move on almost every column."""
    r = np.random.default_rng(seed)
    return (r.random((n, n)) * 9.9).astype(dtype)


def hpl_ai_matrix(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """HPL-AI / HPL-MxP-style matrix: centered uniform entries plus a
    dominant diagonal shift n/4, so kappa(A) stays small."""
    r = np.random.default_rng(seed)
    a = (r.random((n, n)) - 0.5).astype(dtype)
    idx = np.arange(n)
    a[idx, idx] += n / 4.0
    return a


def random_conditioned(n: int, kappa: float, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Matrix with prescribed 2-norm condition number ``kappa`` via
    U * diag(logspace(0, -log10(kappa))) * V^T."""
    r = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(r.standard_normal((n, n)))
    q2, _ = np.linalg.qr(r.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(kappa), n)
    return (q1 * s @ q2.T).astype(dtype)
