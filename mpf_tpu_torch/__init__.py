"""mpf_tpu_torch — mixed-precision dense LU factorization on PyTorch + CUDA.

The port of `mpf_tpu` (JAX/Pallas on a TPU) to one NVIDIA H100: the
single-device `mpf_factorize` / `make_mpf` under the policies MPF_BF16
(default), MPF_REF, PURE_FP32 and MPF_FP16, with ``pivot=False``, a custom
``panel_kernel`` and any r and block.  Block columns take the fused path
or the masked path (the reference's own algorithm), running hand-written
Hopper kernels (``csrc/``) on CUDA tensors and their plain PyTorch versions
on CPU tensors.  A numpy input goes to ``cuda:0`` unless ``device="cpu"``.

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
