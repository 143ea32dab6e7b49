"""L0: precision policies and cast utilities (PyTorch).

Port of `mpf_tpu/precision.py`.  A :class:`PrecisionPolicy` carries the
dtype story of one factorization:

  * ``working``  — storage/working precision of the matrix
  * ``panel``    — precision of the pre-pivoting panel LU whose factors are
                   discarded (only pivots survive)
  * ``gemm_in``  — input precision of the trailing-update GEMM operands
  * ``accum``    — accumulation precision of every contraction
  * ``residual`` — residual precision for iterative refinement

``saturate_panel=True`` reproduces the reference's explicit saturate +
flush-to-zero cast (`fp16_utils.h:15-23`) for the panel dtype, using that
dtype's own ``finfo``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype policy for a mixed-precision LU factorization."""

    name: str
    working: torch.dtype
    panel: torch.dtype
    gemm_in: torch.dtype
    accum: torch.dtype
    residual: torch.dtype
    saturate_panel: bool = False

    def __repr__(self) -> str:
        def nm(d):
            return str(d).removeprefix("torch.")

        return (
            f"PrecisionPolicy({self.name}: working={nm(self.working)}, "
            f"panel={nm(self.panel)}, gemm_in={nm(self.gemm_in)}, "
            f"accum={nm(self.accum)}, saturate={self.saturate_panel})"
        )


#: Default policy: fp32 working matrix, bf16 pre-pivoting panel, bf16
#: trailing-GEMM inputs with fp32 accumulation.
MPF_BF16 = PrecisionPolicy(
    name="mpf_bf16",
    working=torch.float32,
    panel=torch.bfloat16,
    gemm_in=torch.bfloat16,
    accum=torch.float32,
    residual=torch.float32,
)

#: The reference's fp16 panel semantics (saturating cast), fp32 elsewhere.
MPF_FP16 = PrecisionPolicy(
    name="mpf_fp16",
    working=torch.float32,
    panel=torch.float16,
    gemm_in=torch.float32,
    accum=torch.float32,
    residual=torch.float32,
    saturate_panel=True,
)

#: Only pivot selection is low precision (bf16 panel); fp32 everywhere else.
MPF_REF = PrecisionPolicy(
    name="mpf_ref",
    working=torch.float32,
    panel=torch.bfloat16,
    gemm_in=torch.float32,
    accum=torch.float32,
    residual=torch.float32,
)

#: Everything in fp32 — the accuracy reference point.
PURE_FP32 = PrecisionPolicy(
    name="pure_fp32",
    working=torch.float32,
    panel=torch.float32,
    gemm_in=torch.float32,
    accum=torch.float32,
    residual=torch.float32,
)

#: bf16 everywhere except fp32 accumulation.
ALL_BF16 = PrecisionPolicy(
    name="all_bf16",
    working=torch.bfloat16,
    panel=torch.bfloat16,
    gemm_in=torch.bfloat16,
    accum=torch.float32,
    residual=torch.float32,
)

POLICIES = {p.name: p for p in (MPF_BF16, MPF_REF, MPF_FP16, PURE_FP32, ALL_BF16)}


def cast_to_panel(x: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    """Cast a working-precision tensor to the policy's panel dtype.

    With ``saturate_panel``: clamp to the panel dtype's +-max, flush
    magnitudes below its smallest normal to +0, then round to nearest even
    (a plain ``.to()``) — the reference's cast (`fp16_utils.h:15-23`).
    """
    if x.dtype == policy.panel:
        return x
    if policy.saturate_panel:
        fi = torch.finfo(policy.panel)
        x = torch.clamp(x, -fi.max, fi.max)
        x = torch.where(x.abs() < fi.tiny, torch.zeros_like(x), x)
    return x.to(policy.panel)


def widen_from_panel(x: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    """Panel dtype -> working dtype (reference `fp16_to_double`)."""
    return x.to(policy.working)
