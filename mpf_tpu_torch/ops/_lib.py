"""Build, load and bind the Hopper kernels; launch and call counters.

The CUDA sources in ``mpf_tpu_torch/csrc`` are compiled by ``nvcc``, one
process per source and all started together, then linked into one shared
library with a plain C interface and loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c csrc/<name>.cu -o <build>/<name>.o     (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <build>/libmpf_kernels.so *.o

The build happens at the first CUDA use (never at import: importing the
package needs neither ``nvcc`` nor a card), into
``mpf_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and flags.
What ``ptxas -v`` says of every kernel (registers, stack, spills) is kept
there as ``ptxas.txt`` and read by :func:`ptxas_report`.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`call` raises when it is nonzero.  Each kernel has a launch counter
(bumped by its wrapper where it launches) and each plain PyTorch version a
call counter (bumped by the plain version itself), so a run can show which
path it took; the block-column loop counts its block columns by path and
its r-panels.

:func:`span` names a stage of the block-column loop (``mpf.panel``, with
``mpf.update`` inside it and, on the masked path, ``mpf.prepivot``,
``mpf.swap`` and ``mpf.npv`` beside it; ``mpf.exchange``, ``mpf.u12``,
``mpf.trailing``) for ``torch.profiler``: while a profiler records, it is
a ``record_function`` range, on the profiler's clock beside the device
activity, and each device operation launched inside it is correlated with
it; otherwise it is one shared no-op context.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: The kernels, one wrapper each: 1-6 carry the fused path (12 in place of
#: 3 for bf16 slabs, ALL_BF16; 13 for the lookahead driver's wide update;
#: 14 for the deferred-overflow exchange), 5-9 the masked path (8b is
#: kernel 8 without the inverses, for callers that need only the LU); 10
#: and 11 are on no driver path (tests and the smoke call only);
#: 15a-15d carry the pair-layout (n/2, 2, n) driver beside 1-6; 16a-16k
#: are the ``tools/`` design probes (``mpf_tpu_torch/tools``), on no driver
#: path.
KERNELS = (
    "strip_pivots",   # 1  A1 pivot search
    "rowblock",       # 2  A2 row-block assembly
    "panel_update",   # 3  B streaming update, fp32 slabs
    "rows_exchange",  # 4  bounded row exchange
    "tri_inv",        # 5  unit-lower inverse leaves
    "trailing_sub",   # 6  trailing GEMM
    "hgetf2",         # 7  round-1 pre-pivoting panel search
    "npv_inv",        # 8  no-pivot diagonal LU with L^-1 and U^-1
    "npv",            # 8b no-pivot diagonal LU
    "laswp",          # 9  bounded row exchange of the masked path
    "l21_trim",       # 12 B for bf16 slabs: the L21 pass
    "upd_wide",       # 12 B for bf16 slabs: the update pass
    "rows_gather",    # 11 gather of arbitrary rows
    "rows_scatter",   # 11 in-place row scatter (from values or from the band)
    "gemmx",          # 13 trailing GEMM with the next row exchange inside it
    "copy_rows",      # 14 band -> overflow row-block copy
    "flush_overflow", # 14 overflow rows to their homes
    "panel_update_full",  # 10 B over the full slab width, one launch
    "slab_extract",   # 15a pair layout: block-column slab out of the matrix
    "slab_writeback", # 15b pair layout: the slab back into the matrix
    "band_write",     # 15c pair layout: pivot rows over the band
    "u12_inplace",    # 15d pair layout: U12 = L11^-1 A12 in place
    "probe_sched_read",     # 16a probe_r4 smem: three schedule entries
    "probe_bulk_copy",      # 16b probe_r4 hbm2smem: TMA bulk copy on an mbarrier
    "probe_row_ring",       # 16c probe_r4 rowdma: strided rows through a ring
    "probe_overlap",        # 16d probe_r4 overlap: GEMM steps beside streamed reads
    "probe_window_rmw",     # 16e granule_r5: window read-modify-write
    "probe_window_gather",  # 16f granule_r5: read-only window visits
    "probe_relayout",       # 16g micro_3d: collapse / split copies, tchunk transpose
    "probe_gemm3d",         # 16h micro_3d: C3 - A3 @ B (kernel 6 on the views)
    "probe_xsel",           # 16i xsel_micro: dynamic rows of an on-chip window
    "probe_refview",        # 16j refview_r5: 16e on the (N/g, g, W) view
    "probe_dot",            # 16k crash_bisect_r5: bf16(A @ B)
)

launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}
#: Copies made by :func:`gemm_operand`: bf16 GEMM operands of kernels 6, 12
#: (its update pass) and 13 that TMA could not read in place (0 on the main
#: path).
copies = {"gemm_operand": 0}
#: Kernel 6's launches by instance: the Hopper routine with C through shared
#: memory (``staged``) or in registers (``registers``), and the FFMA routine
#: (``ffma``); together they are ``launches["trailing_sub"]``.
trailing_instances = {"staged": 0, "registers": 0, "ffma": 0}
#: Block columns factored by the block-column loop, by path.
block_columns = {"fused": 0, "masked": 0}
#: r-panels run inside those block columns, by path.
panels = {"fused": 0, "masked": 0}

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of each C entry point (pointers and the stream as c_void_p)
_SIGS = {
    "mpf_strip_pivots": [I, I, P, L, I, I, P, P, P, I, I, I, P, I, P],
    "mpf_strip_scratch_bytes": [I],
    "mpf_strip_barrier_probe": [I, I, P, I, P],
    "mpf_rowblock": [I, I, P, L, P, I, P, P, P, P, I, P],
    "mpf_panel_update": [I, I, I, P, L, I, P, I, P, P, P, I, P],
    "mpf_l21_trim": [I, I, P, L, I, P, I, P, P, L, P],
    "mpf_upd_wide": [I, I, I, P, L, P, L, P, L, I, P],
    "mpf_rows_exchange": [I, I, P, L, I, P, P, P, I, P],
    "mpf_tri_inv": [I, I, P, L, P, P, P, L, I, P],
    "mpf_trailing_sub": [I, I, I, I, P, L, P, L, P, I, L, P],
    "mpf_hgetf2_scratch_bytes": [I, I],
    "mpf_hgetf2_panel_bytes": [I, I, I, I],
    "mpf_hgetf2": [I, I, P, L, I, I, I, P, P, P, P, P, P, P, I, P],
    "mpf_npv": [I, P, L, P, P, P, P, I, P],
    "mpf_laswp": [I, I, P, L, P, P, P, I, P],
    "mpf_rows_gather": [I, I, P, L, P, P, I, P],
    "mpf_rows_scatter": [I, I, P, L, P, P, L, P, P, I, I, P],
    "mpf_gemmx": [I, I, I, I, P, L, P, L, P, I, L, I, I, I, I, I, P, P, P, P],
    "mpf_copy_rows": [I, I, P, L, I, I, I, P],
    "mpf_flush_overflow": [I, I, P, L, I, P, I, P],
    "mpf_panel_update_full": [I, I, I, P, L, I, P, I, P, P, I, I, P],
    "mpf_block_copy": [I, I, P, L, P, L, I, P],
    "mpf_u12_inplace": [I, I, P, L, P, L, I, P],
    "mpf_probe_sched_read": [I, P, P, P, I, P],
    "mpf_probe_bulk_copy": [P, I, I, P, P, I, P],
    "mpf_probe_row_ring": [I, I, P, L, I, I, I, I, P, P],
    "mpf_probe_window_rmw": [I, I, L, P, P, I, I, P],
    "mpf_probe_window_gather": [I, I, I, I, P, P, I, I, P, P],
    "mpf_probe_transpose": [I, I, P, L, P, L, I, P],
    "mpf_probe_xsel": [I, I, I, I, P, P, P, P],
    "mpf_probe_dot": [I, I, I, P, L, P, L, P, L, P],
    "mpf_probe_overlap": [I, I, I, P, P, P, I, P, I, L, I, I, P, P, P],
    "mpf_error_string": [I],
}
_RESTYPES = {"mpf_error_string": ctypes.c_char_p, "mpf_hgetf2_scratch_bytes": L,
             "mpf_hgetf2_panel_bytes": L,
             "mpf_strip_scratch_bytes": L}

_lib = None
_lock = threading.Lock()


def reset_counts() -> None:
    for d in (launches, plain_calls, copies, trailing_instances, block_columns, panels):
        for k in d:
            d[k] = 0


_NO_SPAN = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A context naming a stage for ``torch.profiler``: a
    ``record_function(name)`` range while a profiler records, else one
    shared no-op context.  The check is the profiler's own enabled flag:
    building a ``record_function`` costs about ten microseconds even with
    no profiler running, which the loop's few hundred stages a
    factorization would add to the host's issue time."""
    return torch.profiler.record_function(name) if _profiling() else _NO_SPAN


def counted_launch(name: str) -> None:
    launches[name] += 1


def counted_plain(name: str) -> None:
    plain_calls[name] += 1


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def build() -> Path:
    """Compile the kernels if this source set has not been built yet;
    return the path of the shared library."""
    flags = ARCH_FLAGS + NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libmpf_kernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    errors, logs = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    (out_dir / "ptxas.txt").write_text("".join(logs))
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out_dir / f"libmpf_kernels.{tag}.so"
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    for _, obj, _ in jobs:
        obj.unlink()
    return so


def ptxas_report(pattern: str, log: str | None = None) -> dict:
    """What ``ptxas -v`` said of every function whose mangled name contains
    ``pattern``: ``{name: {"registers", "stack", "spill_stores",
    "spill_loads"}}`` (registers for kernels only), read from ``log`` or
    else from the build's ``ptxas.txt`` (building first if need be)."""
    if log is None:
        log = (build().parent / "ptxas.txt").read_text()
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None or pattern not in name:
            continue
        entry = report.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return report


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGS.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, I)
            _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Call C entry point ``name`` with ``args`` plus the current stream;
    raise if it reports a CUDA error."""
    handle = lib()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(handle, name)(*args, stream)
    if rc != 0:
        msg = handle.mpf_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU (the plain version runs); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {kinds}")


def tma_ready(t: torch.Tensor) -> bool:
    """True when TMA can read the 2-D matrix ``t`` in place: a 16-byte
    aligned base, a row stride that is a multiple of 16 bytes and at least
    the row's width, unit column stride."""
    es = t.element_size()
    return (t.dim() == 2 and t.stride(1) == 1 and t.data_ptr() % 16 == 0
            and (t.stride(0) * es) % 16 == 0 and t.stride(0) >= t.shape[1])


def gemm_operand(t: torch.Tensor) -> torch.Tensor:
    """A bf16 GEMM operand of kernels 6 and 13 as their tensor maps take it:
    ``t`` itself when it is not bf16 or :func:`tma_ready`, else a new
    zero-padded ``(rows, ceil8(cols))`` bf16 buffer holding ``t`` in its
    leading columns (counted in ``copies``).  The caller passes the
    operand's logical sizes beside the buffer's row stride."""
    if t.dtype != torch.bfloat16 or tma_ready(t):
        return t
    rows, cols = t.shape
    buf = torch.zeros((rows, -(-cols // 8) * 8), dtype=t.dtype, device=t.device)
    buf[:, :cols] = t
    copies["gemm_operand"] += 1
    return buf


def fms(b: torch.Tensor, m: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``b - m * u`` on fp32 tensors, rounded ONCE, as a fused multiply-add
    rounds it (the kernels' ``fmaf(-m, u, b)``; XLA on the CPU contracts the
    JAX package's ``b - m * u`` the same way).  The fp32 product is exact in
    fp64, so only the final fp64 -> fp32 step rounds twice, which changes
    a result only when the fp64 difference lands exactly on an fp32 tie."""
    return (b.double() - m.double() * u.double()).float()


def sub_mul(b: torch.Tensor, m: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``b - m * u`` in ``b``'s dtype with the round points of the JAX
    package's CPU backend (probed bitwise against jitted JAX functions):

    * fp32: one fused multiply-add (:func:`fms`);
    * bf16: the product rounded to bf16, then the difference rounded to bf16;
    * fp16: the exact result rounded once to fp16 (:func:`f16_rn`; the
      product of two fp16 values is exact in fp32, but rounding the fp32
      difference again to fp16 can land on an fp16 midpoint)."""
    if b.dtype == torch.bfloat16:
        prod = (m.float() * u.float()).to(torch.bfloat16).float()
        return (b.float() - prod).to(torch.bfloat16)
    if b.dtype == torch.float16:
        return f16_rn(b.double() - m.double() * u.double())
    return fms(b, m, u).to(b.dtype)


def f16_rn(z: torch.Tensor) -> torch.Tensor:
    """fp64 ``z`` rounded ONCE to the nearest fp16 (ties to even).  torch
    converts fp64 to fp16 through fp32, rounding twice; rounding to odd at
    fp32 (truncate, then set the last bit when inexact) and then to nearest
    at fp16 rounds once, as fp32 keeps two bits more than fp16 needs.
    Kernel 7 rounds its fp16 update the same way (csrc/hgetf2.cu)."""
    f = z.float()
    fd = f.double()
    trunc = torch.where(fd.abs() > z.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    odd = (trunc.view(torch.int32) | 1).view(torch.float32)
    return torch.where(fd == z, f, odd).to(torch.float16)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
