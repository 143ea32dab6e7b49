"""The TPU design probes of ``tools/`` on the card.

Each module here ports one TPU tool: its kernels become hand-written Hopper
kernels (``csrc/probes.cu``, ``csrc/probes_gemm.cu``; 16g and 16h reuse
kernels 15a and 6), each beside a plain PyTorch version, and its legs run at
the tool's own default shapes::

    python -m mpf_tpu_torch.tools.probe_r4 [smem hbm2smem rowdma overlap]
    python -m mpf_tpu_torch.tools.granule_r5 [W]
    python -m mpf_tpu_torch.tools.refview_r5
    python -m mpf_tpu_torch.tools.xsel_micro
    python -m mpf_tpu_torch.tools.micro_3d
    python -m mpf_tpu_torch.tools.crash_bisect_r5 [w|s|k|all]

Every module's ``run(dev, ...)`` returns one dict a leg (:func:`leg`) and
prints one line a leg: the tool's quantity (ns/visit, GB/s, us/step, TF/s)
from CUDA events (``utils.timing.cuda_time``), the tool's own exactness
check, the kernel held against its plain version, and the plain version's
and one PyTorch call's times.  ``--device cpu`` runs the plain versions
(what the wrappers run for CPU tensors) and measures no time.  A failed leg
makes ``main`` exit 1; ``chip_smoke.py`` phase 2g runs every module.
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.utils.timing import cuda_time


def device(name: str) -> torch.device:
    """``cuda`` (card 0) or ``cpu``; a card asked for and missing raises."""
    dev = torch.device("cuda", 0) if name == "cuda" else torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs the plain versions")
    return dev


def time_ms(fn: Callable, dev: torch.device, iters: int = 3, warmup: int = 1):
    """Median ms of ``fn()`` on the card (CUDA events), None on the CPU: a
    CPU run measures no device time."""
    if dev.type != "cuda":
        return None
    return cuda_time(fn, warmup=warmup, iters=iters)[0] * 1e3


def check_ids(ids, n: int, name: str) -> None:
    """The plain versions' check that every id names one of ``n`` windows
    or rows; the kernels skip an id that does not, since checking on the
    card would cost a host synchronisation inside the timed call."""
    if ids.numel():
        _lib.check(0 <= int(ids.min()) and int(ids.max()) < n,
                   f"{name}: ids must lie in [0, {n})")


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def rate(ms, fn: Callable[[float], float], unit: str, spec: str = ".1f") -> str:
    """``fn(seconds)`` with its unit, or "not measured" without a time."""
    return f"{unit} not measured" if ms is None else f"{fn(ms / 1e3):{spec}} {unit}"


def max_abs(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """A kernel's output against its plain version's: ``max_abs_err``, the
    largest |got - ref| (0 when they are equal, found without a copy), and
    ``rel_err``, that over max |ref| (None where ref is all zeros)."""
    err = 0.0 if torch.equal(got, ref) else max_abs(got, ref)
    top = float(torch.maximum(ref.max().abs(), ref.min().abs())) if ref.numel() else 0.0
    return dict(max_abs_err=err, rel_err=err / top if top > 0 else None)


def leg(kernel: str, name: str, ok: bool, text: str, *, max_abs_err: float, rel_err,
        ms=None, plain_ms=None, library=None, nbytes: float = 0.0,
        fp32_ops: float = 0.0, bf16_ops: float = 0.0, **extra) -> dict:
    """One leg's result, printed as one line.  ``max_abs_err`` /
    ``rel_err``: the kernel against its plain version (:func:`errors`).
    ``nbytes`` / ``fp32_ops`` / ``bf16_ops``: what the function must move and
    compute (each input read once, each output written once), from which a
    caller states the card's least time."""
    rel = "none" if rel_err is None else f"{rel_err:.3e}"
    print(f"{name}: {text}  {'OK' if ok else 'FAIL'}  ms={fmt(ms)} plain_ms={fmt(plain_ms)} "
          f"library_ms={fmt(library)} max_abs_err={max_abs_err:.3e} rel_err={rel}", flush=True)
    return dict(kernel=kernel, leg=name, ok=bool(ok), ms=ms, plain_ms=plain_ms,
                library_ms=library, max_abs_err=float(max_abs_err),
                rel_err=None if rel_err is None else float(rel_err), bytes=float(nbytes),
                fp32_ops=float(fp32_ops), bf16_ops=float(bf16_ops), **extra)


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the kernels on card 0 (default); cpu: the plain versions")
    return p


def finish(results: list) -> int:
    bad = [r["leg"] for r in results if not r["ok"]]
    print(f"{len(results) - len(bad)} of {len(results)} legs OK"
          + (f"; FAILED: {' '.join(bad)}" if bad else ""), flush=True)
    return 1 if bad else 0
