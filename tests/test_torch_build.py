"""The build's ``ptxas -v`` report (``mpf_tpu_torch.ops._lib.ptxas_report``)
read from a log in the form ptxas prints it: each kernel's registers,
stack and spills, filtered by a part of the mangled name.  No ``nvcc`` is
needed: the log is given."""

import pytest

from mpf_tpu_torch.ops import _lib

_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4gemm4ffma15ffma_sub_kernelILb1EEEvNS0_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4gemm4ffma15ffma_sub_kernelILb1EEEvNS0_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 456 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_18exchangeIjEEvPT_xiiiPKiS4_S2_
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117gemmx_ffma_kernelILb0EEEvN4gemm4ffma4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117gemmx_ffma_kernelILb0EEEvN4gemm4ffma4ArgsE
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_Z10tri_inv_kernelPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z10tri_inv_kernelPKfPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""


@pytest.mark.parametrize("pattern,want", [
    ("ffma", {
        "_ZN4gemm4ffma15ffma_sub_kernelILb1EEEvNS0_4ArgsE":
            {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 128},
        "_ZN12_GLOBAL__N_117gemmx_ffma_kernelILb0EEEvN4gemm4ffma4ArgsE":
            {"stack": 24, "spill_stores": 8, "spill_loads": 12, "registers": 128},
    }),
    ("exchange", {"_ZN12_GLOBAL__N_18exchangeIjEEvPT_xiiiPKiS4_S2_":
                  {"stack": 16, "spill_stores": 0, "spill_loads": 0}}),
    ("tri_inv", {"_Z10tri_inv_kernelPKfPf":
                 {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 40}}),
    ("no_such_kernel", {}),
], ids=["ffma_kernels", "device_function", "one_kernel", "none"])
def test_ptxas_report_parses_the_log(pattern, want):
    assert _lib.ptxas_report(pattern, _LOG) == want


def test_build_asks_ptxas_for_its_report():
    """The flags that key the build hash carry ``-Xptxas -v``, so every
    build writes the report that ``ptxas_report`` reads."""
    flags = _lib.NVCC_FLAGS
    assert "-Xptxas" in flags and flags[flags.index("-Xptxas") + 1] == "-v"
