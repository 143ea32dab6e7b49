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


# the L21 pass of kernels 3 and 12 (fp32 with TMA, bf16 with copies), kernel
# 5 (fp32, bf16) and the Hopper routine's instance with C through shared
# memory, as their mangled names appear in the build's report
_L21 = "_ZN3l2112_GLOBAL__N_110l21_kernelIfLb1EEEv14CUtensorMap_stS2_NS_4ArgsE"
_L21_BF = "_ZN3l2112_GLOBAL__N_110l21_kernelI13__nv_bfloat16Lb0EEEv14CUtensorMap_stS3_NS_4ArgsE"
_K5 = "_ZN12_GLOBAL__N_114tri_inv_kernelIfEEvPKT_xPKiS5_PS1_xi"
_K5_BF = "_ZN12_GLOBAL__N_114tri_inv_kernelI13__nv_bfloat16EEvPKT_xPKiS6_PS2_xi"
_SMEM_C = "_ZN4gemm4sm9015trailing_kernelI13__nv_bfloat16Lb1EEEv14CUtensorMap_stS3_S3_iiiPT_x"


def _entry(name, regs, stack=0, spill=0):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, 400 bytes cmem[0]\n")


_LOG2 = ("ptxas info    : 0 bytes gmem\n" + _entry(_L21, 168) + _entry(_L21_BF, 154)
         + _entry(_K5, 40) + _entry(_K5_BF, 44, stack=8, spill=4) + _entry(_SMEM_C, 168))


def _reg(regs, stack=0, spill=0):
    return {"stack": stack, "spill_stores": spill, "spill_loads": spill, "registers": regs}


@pytest.mark.parametrize("pattern,want", [
    ("l21_kernel", {_L21: _reg(168), _L21_BF: _reg(154)}),
    ("tri_inv_kernel", {_K5: _reg(40), _K5_BF: _reg(44, stack=8, spill=4)}),
    ("trailing_kernel", {_SMEM_C: _reg(168)}),
    ("ffma", {}),
], ids=["l21_pass", "kernel5", "smem_c_instance", "none_of_ffma"])
def test_ptxas_report_reads_the_l21_and_kernel5_names(pattern, want):
    assert _lib.ptxas_report(pattern, _LOG2) == want


def test_build_asks_ptxas_for_its_report():
    """The flags that key the build hash carry ``-Xptxas -v``, so every
    build writes the report that ``ptxas_report`` reads."""
    flags = _lib.NVCC_FLAGS
    assert "-Xptxas" in flags and flags[flags.index("-Xptxas") + 1] == "-v"
