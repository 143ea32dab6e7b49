"""mpf_tpu_torch — mixed-precision dense LU factorization on PyTorch + CUDA.

The port of `mpf_tpu` (JAX/Pallas on a TPU) to one NVIDIA H100.  This slice
is the single-device fused main path: `mpf_factorize` / `make_mpf` under
the policies MPF_BF16 (default), MPF_REF and PURE_FP32, running six
hand-written Hopper kernels (``csrc/``) on CUDA tensors and their plain
PyTorch versions on CPU tensors.

Layer map:
  L0 precision policy  -> mpf_tpu_torch.precision
  L1 device kernels    -> mpf_tpu_torch.ops (plain versions + CUDA wrappers)
  L2 blocked driver    -> mpf_tpu_torch.models.mpf
  L3 host utilities    -> mpf_tpu_torch.utils, mpf_tpu_torch.convert
"""

from mpf_tpu_torch.precision import (
    PrecisionPolicy,
    MPF_BF16,
    MPF_REF,
    MPF_FP16,
    PURE_FP32,
    ALL_BF16,
    cast_to_panel,
)
from mpf_tpu_torch.models.mpf import MPFResult, mpf_factorize, make_mpf

__version__ = "0.1.0"

__all__ = [
    "PrecisionPolicy",
    "MPF_BF16",
    "MPF_REF",
    "MPF_FP16",
    "PURE_FP32",
    "ALL_BF16",
    "cast_to_panel",
    "MPFResult",
    "mpf_factorize",
    "make_mpf",
]
