"""Build, load and bind the Hopper kernels; launch and call counters.

The CUDA sources in ``mpf_tpu_torch/csrc`` are compiled by ``nvcc`` into one
shared library with a plain C interface and loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/libmpf_kernels.so csrc/*.cu

The build happens at the first CUDA use (never at import: importing the
package needs neither ``nvcc`` nor a card), into
``mpf_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and flags.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`call` raises when it is nonzero.  Each kernel has a launch counter
(bumped by its wrapper where it launches) and each plain PyTorch version a
call counter (bumped by the plain version itself), so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: The six kernels of the main path (one wrapper each).
KERNELS = (
    "strip_pivots",   # 1  A1 pivot search
    "rowblock",       # 2  A2 row-block assembly
    "panel_update",   # 3  B streaming update
    "rows_exchange",  # 4  bounded row exchange
    "tri_inv",        # 5  unit-lower inverse leaves
    "trailing_sub",   # 6  trailing GEMM
)

launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of each C entry point (pointers and the stream as c_void_p)
_SIGS = {
    "mpf_strip_pivots": [I, I, P, L, I, I, P, P, P, I, I, P, P, I, P],
    "mpf_strip_record_bytes": [],
    "mpf_rowblock": [I, I, P, L, P, I, P, P, P, P, P],
    "mpf_panel_update": [I, I, I, P, L, I, P, I, P, P, P, I, P],
    "mpf_rows_exchange": [I, I, P, L, I, P, P, P, P],
    "mpf_tri_inv": [I, I, P, L, P, P, P, L, P],
    "mpf_trailing_sub": [I, I, I, I, P, L, P, L, P, L, P],
    "mpf_error_string": [I],
}

_lib = None
_lock = threading.Lock()


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


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
    tmp = out_dir / f"libmpf_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *flags, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGS.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p if name == "mpf_error_string" else I
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


def fms(b: torch.Tensor, m: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``b - m * u`` on fp32 tensors, rounded ONCE, as a fused multiply-add
    rounds it (the kernels' ``fmaf(-m, u, b)``; XLA on the CPU contracts the
    JAX package's ``b - m * u`` the same way).  The fp32 product is exact in
    fp64, so only the final fp64 -> fp32 step rounds twice, which changes
    a result only when the fp64 difference lands exactly on an fp32 tie."""
    return (b.double() - m.double() * u.double()).float()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
