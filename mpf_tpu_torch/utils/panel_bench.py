"""Kernels 1 and 2 alone on the card, at the main path's shapes.

    python -m mpf_tpu_torch.utils.panel_bench [--reps 5]

Times ``strip_panel_pivots`` (kernel 1: the first panel, r = 128, of the
HPL-AI slab of n = 16384 rows, bf16 and fp32 panels from the fp32 slab, a
bf16 panel from the bf16 slab; and of a uniform bf16 slab of 65536 rows)
and ``rowblock_assemble`` (kernel 2: the pivot rows kernel 1 picks on the
uniform slab, r = 128, 1024 columns, fp32 and bf16) and prints one JSON
line: per case the wrapper's time (CUDA events over ``--reps`` calls back to
back, the host's issue time where that is longer) and the device's
(``device_ms``: the calls captured in one CUDA graph and replayed), with
the timers of ``utils/timing.py`` that ``chip_smoke.py`` uses.  It calls
only those two public wrappers, so it measures another tree of the
package once that tree has this file and ``utils/timing.py``:
``PYTHONPATH=<tree> python <tree>/mpf_tpu_torch/utils/panel_bench.py``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

_N, _R, _BC, _BIG = 16384, 128, 1024, 65536


def panel_times(reps: int = 5) -> dict:
    """{case: {"ms", "device_ms"}} for kernels 1 and 2 (see the module
    docstring), with the device's name."""
    from mpf_tpu_torch.ops.panel_fused import rowblock_assemble
    from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots
    from mpf_tpu_torch.utils import matgen
    from mpf_tpu_torch.utils.timing import event_ms, graph_ms

    if not torch.cuda.is_available():
        raise RuntimeError("panel_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    bf, f32 = torch.bfloat16, torch.float32
    hpl = torch.from_numpy(matgen.hpl_ai_matrix(_N, seed=1)[:, :_BC].copy()).to(dev)
    uni = torch.from_numpy(matgen.random_dense(_N, seed=2)[:, :_BC].copy()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    big = (torch.rand((_BIG, _BC), generator=gen, device=dev) * 2 - 1).to(bf)
    pos = torch.arange(_N, dtype=torch.int32, device=dev)
    pos_big = torch.arange(_BIG, dtype=torch.int32, device=dev)
    hpl_b, uni_b = hpl.to(bf), uni.to(bf)
    glist = strip_panel_pivots(uni, 0, pos, bf, 0, _R)[2]
    glist_b = strip_panel_pivots(uni_b, 0, pos, bf, 0, _R)[2]
    cases = {
        "k1_m16384_fp32slab_bf16panel": lambda: strip_panel_pivots(hpl, 0, pos, bf, 0, _R),
        "k1_m16384_fp32panel": lambda: strip_panel_pivots(hpl, 0, pos, f32, 0, _R),
        "k1_m16384_bf16slab": lambda: strip_panel_pivots(hpl_b, 0, pos, bf, 0, _R),
        "k1_m65536_bf16slab": lambda: strip_panel_pivots(big, 0, pos_big, bf, 0, _R),
        "k2_fp32": lambda: rowblock_assemble(uni, glist, 0),
        "k2_bf16": lambda: rowblock_assemble(uni_b, glist_b, 0),
    }
    out = {name: {"ms": event_ms(fn, reps), "device_ms": graph_ms(fn)}
           for name, fn in cases.items()}
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    print(json.dumps(panel_times(ap.parse_args().reps)))


if __name__ == "__main__":
    main()
