"""Matrix generators, ported from `mpf_tpu/utils/matgen.py`.

* :func:`generate_corpus` replicates the reference's `matrix_generator.cpp`
  (glibc ``rand()`` consumption order, size schedule, value distribution)
  bit for bit.
* :func:`random_dense`, :func:`hpl_ai_matrix`, :func:`random_conditioned`
  are the fast seeded host (numpy) generators the benchmarks and tests use.
  The same seed gives the same matrix as the JAX package's generators, so
  the two packages can be compared on identical inputs.
* :func:`hpl_ai_matrix_device`, :func:`random_dense_device` make the same
  classes directly on a device with a ``torch.Generator`` (an n = 65536
  fp64 host matrix would be 34 GB), in 2D or as the (n/2, 2, n) pair
  layout (``pairs=True``).  Their values are not the JAX PRNG's:
  the class, the seed's determinism and the storage rounding are what
  carry over.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

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


#: fp32 elements per generation chunk of the device generators (256 MB)
_CHUNK_ELEMS = 1 << 26


def _device_uniform(n: int, seed: int, dtype, device, finish, ext_rows: int = 0,
                    pairs: bool = False) -> torch.Tensor:
    """(n + ext_rows, n) matrix of ``dtype`` on ``device``: the first n rows
    from U[0, 1) fp32 values of a ``torch.Generator`` seeded with ``seed``
    on that device, made in row chunks (one fp32 chunk at a time, so the
    peak is the output plus one chunk).  ``finish(x, r0)`` turns the fp32
    chunk of rows r0.. into its final fp32 values in place; each value is
    then cast to ``dtype`` once.  The chunk height depends on n only, so
    every dtype sees the same fp32 values.  The ``ext_rows`` rows below are
    zeros, made after the n rows, so the first n rows are bit-identical to
    the ``ext_rows=0`` output.  ``pairs``: return the (n/2, 2, n) view of
    the (n, n) output, row i at ``[i // 2, i % 2]`` (the same bits)."""
    if pairs and (ext_rows or n % 2):
        raise ValueError("the pair layout takes an even n and no overflow rows "
                         f"(n={n}, ext_rows={ext_rows})")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = torch.empty((n + ext_rows, n), dtype=dtype, device=dev)
    out[n:] = 0
    chunk = max(1, _CHUNK_ELEMS // max(n, 1))
    for r0 in range(0, n, chunk):
        x = torch.rand((min(chunk, n - r0), n), generator=gen, dtype=torch.float32,
                       device=dev)
        finish(x, r0)
        out[r0:r0 + x.shape[0]] = x
    return out.view(n // 2, 2, n) if pairs else out


def hpl_ai_matrix_device(n: int, seed: int = 0, dtype=torch.float32,
                         device="cuda:0", ext_rows: int = 0,
                         pairs: bool = False) -> torch.Tensor:
    """The :func:`hpl_ai_matrix` class made on ``device``: U[-0.5, 0.5)
    entries plus the diagonal shift n/4, computed in fp32 and cast to
    ``dtype`` once (`mpf_tpu/utils/matgen.py:98-146`).  ``ext_rows``: rows
    appended below (zeros), the deferred exchange's pre-extended input
    (`models/mpf.py:defer_extension`); the first n rows do not depend on
    it.  ``pairs=True``: the (n/2, 2, n) pair-layout view of the same
    matrix (the pair-layout driver's input), bit for bit the 2D output;
    the pair layout excludes ``ext_rows`` (ValueError)."""
    def finish(x, r0):
        x.sub_(0.5)
        x.diagonal(r0).add_(n / 4.0)
    return _device_uniform(n, seed, dtype, device, finish, ext_rows, pairs)


def random_dense_device(n: int, seed: int = 0, dtype=torch.float32,
                        device="cuda:0", ext_rows: int = 0,
                        pairs: bool = False) -> torch.Tensor:
    """The :func:`random_dense` class (uniform [0, 9.9]) made on
    ``device``, computed in fp32 and cast to ``dtype`` once
    (`mpf_tpu/utils/matgen.py:149-168`); ``ext_rows`` and ``pairs`` as in
    :func:`hpl_ai_matrix_device`."""
    return _device_uniform(n, seed, dtype, device, lambda x, r0: x.mul_(9.9), ext_rows, pairs)


def random_conditioned(n: int, kappa: float, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Matrix with prescribed 2-norm condition number ``kappa`` via
    U * diag(logspace(0, -log10(kappa))) * V^T."""
    r = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(r.standard_normal((n, n)))
    q2, _ = np.linalg.qr(r.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(kappa), n)
    return (q1 * s @ q2.T).astype(dtype)
