"""Carry factorization state between the JAX package and this one.

A factorization has no weights: its state is the matrix and the
``MPFResult``.  These helpers move that state as numpy arrays, so the tests
compare like with like.  Nothing here imports JAX: a JAX result crosses as
numpy arrays (``np.asarray`` of each field) and a JAX policy by its name.
"""

from __future__ import annotations

import numpy as np
import torch

from mpf_tpu_torch.models.mpf import MPFResult
from mpf_tpu_torch.precision import POLICIES, PrecisionPolicy


def policy_from_jax(p) -> PrecisionPolicy:
    """The port's policy of the same name as the JAX package's ``p``."""
    return POLICIES[p.name]


def result_from_numpy(lu, ipiv, info, perm, device="cpu") -> MPFResult:
    """A JAX ``MPFResult`` given as numpy arrays -> the port's, on
    ``device`` (``lu`` keeps its fp32 values; bf16 is widened to fp32)."""
    lu = np.asarray(lu)
    if lu.dtype != np.float32:
        lu = lu.astype(np.float32)
    return MPFResult(
        lu=torch.from_numpy(np.ascontiguousarray(lu)).to(device),
        ipiv=torch.from_numpy(np.asarray(ipiv, np.int32)).to(device),
        info=torch.tensor(int(np.asarray(info)), dtype=torch.int32, device=device),
        perm=None if perm is None
        else torch.from_numpy(np.asarray(perm, np.int32)).to(device),
    )


def result_to_numpy(res: MPFResult) -> MPFResult:
    """The port's result as numpy arrays (lu in fp32, the index arrays in
    int32, info as a numpy int32 scalar)."""
    return MPFResult(
        lu=res.lu.detach().float().cpu().numpy(),
        ipiv=res.ipiv.detach().cpu().numpy().astype(np.int32),
        info=np.int32(int(res.info)),
        perm=None if res.perm is None
        else res.perm.detach().cpu().numpy().astype(np.int32),
    )
