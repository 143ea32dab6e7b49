"""CPU parity of the ``tools/`` probes' port (``mpf_tpu_torch/tools``, kernels
16a-16k) with the TPU tools' own Pallas kernels.

Each TPU tool is loaded from ``tools/`` by path (the directory is no
package), with ``sys.argv`` and the environment restored by ``monkeypatch``,
and its kernels run under ``pltpu.force_tpu_interpret_mode()`` at tiny
shapes (the module globals ``E``, ``N``, ``W``, ``XW`` set by
``monkeypatch``, the ``lru_cache``d builders cleared).  Where a tool builds
its kernel inside a print-only function (``tpu_probe_r4``,
``tpu_crash_bisect_r5``), the test runs that function at a tiny size and
captures the ``pl.pallas_call`` it builds (:class:`_Spy`), then calls it on
the test's own inputs.  The same numpy-seeded inputs go through the port's
plain version (the wrappers take it for CPU tensors); each test states its
tolerance.  Each JAX call is jitted whole and read after it finishes (see
``tests/test_torch_pair3d.py:_jax``).  No kernel launches on the CPU.
"""

import importlib.util
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.tools import (  # noqa: E402
    crash_bisect_r5, granule_r5, micro_3d, probe_r4, refview_r5, xsel_micro)
from mpf_tpu_torch.utils.oracle import sum_slack, within_bf16_ulp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
BF = torch.bfloat16
_JDT = {torch.float32: jnp.float32, BF: jnp.bfloat16}


class _Spy:
    """Stands in for a tool's ``pl``: every ``pallas_call`` it builds is
    kept in ``fns``; everything else is Pallas's own."""

    def __init__(self):
        self.fns = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, **kwargs):
        fn = pl.pallas_call(*args, **kwargs)
        self.fns.append(fn)
        return fn


def _tool(name, monkeypatch, spy=False):
    """The TPU tool ``tools/<name>.py`` as a fresh module (``sys.argv`` as
    its command line expects, the environment it sets restored after the
    test); with ``spy``, its ``pl`` is a :class:`_Spy`, returned beside it."""
    monkeypatch.setattr(sys, "argv", [name])
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       os.environ.get("JAX_COMPILATION_CACHE_DIR", str(REPO / ".jax_cache")))
    path = REPO / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_tpu_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not spy:
        return mod
    s = _Spy()
    monkeypatch.setattr(mod, "pl", s)
    return mod, s


def _run(fn, *args):
    """``fn(*args)`` jitted whole, outputs as fp32 numpy.  Both the build of
    ``fn`` and this call run under ``pltpu.force_tpu_interpret_mode()``."""
    out = jax.jit(lambda *a: jax.tree.map(lambda x: x.astype(jnp.float32)
                                          if jnp.issubdtype(x.dtype, jnp.floating) else x,
                                          fn(*a)))(*args)
    return jax.tree.map(np.array, out)


def _both(a_np, tdt):
    """The same values as a torch tensor of ``tdt`` and a jax array."""
    t = torch.from_numpy(a_np).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(_JDT[tdt])


# --------------------------------------------------------------------------
# tpu_probe_r4: 16a-16d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ns", [64, 2048])
def test_sched_read_vs_jax(monkeypatch, capsys, ns):
    """16a, bitwise: random full-range int32 schedules (the sums wrap) and
    random x through the tool's kernel and the port; the tool's own check
    (exp = 0 + ns/2 + ns - 1 on arange) passes in both."""
    tool, spy = _tool("tpu_probe_r4", monkeypatch, spy=True)
    rng = np.random.default_rng(ns)
    s = rng.integers(-2**31, 2**31, ns, dtype=np.int64).astype(np.int32)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        tool.probe_smem(sizes=(ns,))
        ref = _run(spy.fns[-1], s, x)
    assert f"smem ns={ns}: OK val_ok=True" in capsys.readouterr().out
    got = probe_r4.sched_read(torch.from_numpy(s), torch.from_numpy(x))
    assert np.array_equal(got.numpy(), ref)
    tool_data = probe_r4.sched_read(torch.arange(ns, dtype=torch.int32), torch.zeros(8, 128))
    assert bool((tool_data == float(ns // 2 + ns - 1)).all())


def test_bulk_copy_vs_jax(monkeypatch, capsys):
    """16b, bitwise: the tool's chunk s[512:1024] of a random schedule; its
    own check (exp = C + 2C - 1) passes in both."""
    tool, spy = _tool("tpu_probe_r4", monkeypatch, spy=True)
    rng = np.random.default_rng(7)
    s = rng.integers(-2**31, 2**31, 2048, dtype=np.int64).astype(np.int32)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        tool.probe_hbm2smem(ns=2048)
        ref = _run(spy.fns[-1], s, x)
    assert "hbm2smem: OK val_ok=True" in capsys.readouterr().out
    got = probe_r4.bulk_copy(torch.from_numpy(s), torch.from_numpy(x))
    assert np.array_equal(got.numpy(), ref)
    c = probe_r4.HBM2SMEM_C
    tool_data = probe_r4.bulk_copy(torch.arange(2048, dtype=torch.int32), torch.zeros(8, 128))
    assert bool((tool_data == float(c + 2 * c - 1)).all())


@pytest.mark.parametrize("depth", [4, 16])
def test_row_ring_vs_jax(monkeypatch, capsys, depth):
    """16c, bitwise: on random rows (the tool fills with ones) the tool's
    kernel, the port and the row the tool's formula names agree."""
    tool, spy = _tool("tpu_probe_r4", monkeypatch, spy=True)
    n, w, nrows = 256, 128, 64
    src = np.random.default_rng(depth).standard_normal((n, 1, w)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        tool.probe_rowdma(n=n, w=w, nrows=nrows, depths=(depth,), iters=1)
        ref = _run(spy.fns[-1], src)
    assert "v=1" in capsys.readouterr().out
    got = probe_r4.row_ring(torch.from_numpy(src), nrows, depth).numpy()
    named = src[(probe_r4.row_ring_target(nrows, depth) * probe_r4.ROW_STRIDE) % n]
    assert np.array_equal(got, ref) and np.array_equal(got, named)


@pytest.mark.parametrize("extra_mb", [0, 0.1, 1])
def test_overlap_vs_numpy_and_jax(monkeypatch, extra_mb):
    """16d: the tool prints only a time, so its own output is never read;
    the test captures the kernel it builds and runs it on random bf16
    operands (ti = 16, kk = t = 128, 4 steps; the stream array is the
    tool's (8192, 8192), zeros).  The port's sum is held to numpy's (d[0, 0]
    summed in fp64 and rounded once, then added in fp32 step by step) and
    to the tool kernel's within ``probe_r4.overlap_slack`` (each sums
    d[0, 0]'s exact products in its own order)."""
    tool, spy = _tool("tpu_probe_r4", monkeypatch, spy=True)
    steps = 4
    rng = np.random.default_rng(3)
    l, jl = _both(rng.standard_normal((16, 128)).astype(np.float32), BF)
    u, ju = _both(rng.standard_normal((128, 128)).astype(np.float32), BF)
    with pltpu.force_tpu_interpret_mode():
        tool.probe_overlap(ti=16, t=128, kk=128, steps=steps, extra_mb=(extra_mb,), iters=1)
        j = float(_run(spy.fns[-1], jl, ju, jnp.zeros((8192, 8192), jnp.bfloat16))[0, 0])
    a = torch.zeros((8192, 8192), dtype=BF)
    got = float(probe_r4.overlap(l, u, a, steps, extra_mb)[0])
    d00 = np.float32(l[0].double().numpy() @ u[:, 0].double().numpy())
    acc = np.float32(0)
    for _ in range(steps):
        acc = np.float32(acc + d00)
    tol = probe_r4.overlap_slack(l, u, steps)
    assert abs(got - float(acc)) <= tol and abs(got - j) <= tol


@pytest.mark.parametrize("w,extra_mb", [(512, 0.05), (2048, 0.2), (520, 0.1)])
def test_overlap_checksum_vs_numpy(w, extra_mb):
    """16d's checksum of the streamed bytes, the plain version against a
    numpy loop over the steps and pieces: step s reads overlap_chunks chunks
    of 16 rows, chunk j at row ((s * xrows + j) * 16) mod (rows - 16), cut
    into 16 KB pieces (w = 520: a short last piece) dealt round-robin to
    the blocks; each block XORs the first 32-bit word of its pieces.  The
    TPU kernel discards the bytes, so there is nothing of it to compare."""
    rng = np.random.default_rng(w)
    rows, steps = 100, 5
    a = torch.from_numpy(rng.standard_normal((rows, w)).astype(np.float32)).to(BF)
    l = torch.ones((200, 16), dtype=BF)
    u = torch.ones((16, 384), dtype=BF)
    blocks = probe_r4.overlap_blocks(l, u)
    xrows = probe_r4.overlap_chunks(extra_mb, a)
    assert blocks == 6 and xrows > 0
    words = a.view(torch.int16).numpy().reshape(-1).view(np.int32)
    chunk = 16 * w * 2
    per_chunk = -(-chunk // 16384)
    want = np.zeros(blocks, np.int32)
    for s in range(steps):
        for p in range(xrows * per_chunk):
            j, q = divmod(p, per_chunk)
            row0 = ((s * xrows + j) * 16) % (rows - 16)
            want[p % blocks] ^= words[(row0 * w * 2 + q * 16384) // 4]
    _, sink = probe_r4.overlap(l, u, a, steps, extra_mb)
    assert sink.dtype == torch.int32 and np.array_equal(sink.numpy(), want) and want.any()


# --------------------------------------------------------------------------
# tpu_granule_r5: 16e, 16f
# --------------------------------------------------------------------------

_GN, _GW, _GE = 256, 128, 16  # E >= the deepest ring (d16)


def _granule(monkeypatch):
    tool = _tool("tpu_granule_r5", monkeypatch)
    for k, v in (("N", _GN), ("W", _GW), ("E", _GE)):
        monkeypatch.setattr(tool, k, v)
    tool.build_rmw.cache_clear()
    tool.build_gath.cache_clear()
    return tool


def _ids(rng, nwin, e):
    return np.sort(rng.choice(nwin, size=e, replace=False)).astype(np.int32)


@pytest.mark.parametrize("name,kind,dt,g,d", [leg for leg in granule_r5.LEGS if leg[1] == "rmw"])
def test_window_rmw_vs_jax(monkeypatch, name, kind, dt, g, d):
    """16e, bitwise: every read-modify-write leg of the tool (its g, dtype
    and depth) at N = 256, W = 128, E = 8 on random values."""
    tool = _granule(monkeypatch)
    rng = np.random.default_rng(g * d)
    nwin = _GN // g
    ids = _ids(rng, nwin, _GE)
    a, ja = _both(rng.standard_normal((nwin, g, _GW)).astype(np.float32), dt)
    with pltpu.force_tpu_interpret_mode():
        fn = tool.build_rmw(nwin, g, _GW, jnp.dtype(_JDT[dt]).name, d)
        ref = _run(fn, jnp.asarray(ids), ja)
    got = granule_r5.window_rmw(a, torch.from_numpy(ids), d)
    assert np.array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("name,kind,dt,g,d", [leg for leg in granule_r5.LEGS if leg[1] == "gath"])
def test_window_gather_vs_jax(monkeypatch, name, kind, dt, g, d):
    """16f, bitwise (fp32 sums in the same order, i ascending): every
    read-only leg of the tool on random values; the array passes through
    unchanged in both."""
    tool = _granule(monkeypatch)
    rng = np.random.default_rng(g + d)
    nwin = _GN // g
    ids = _ids(rng, nwin, _GE)
    a, ja = _both(rng.standard_normal((nwin, g, _GW)).astype(np.float32), dt)
    before = a.clone()
    with pltpu.force_tpu_interpret_mode():
        fn = tool.build_gath(nwin, g, _GW, jnp.dtype(_JDT[dt]).name, d)
        ja_out, jo = _run(fn, jnp.asarray(ids), ja)
    got = granule_r5.window_gather(a, torch.from_numpy(ids), d)
    assert np.array_equal(got.numpy(), jo)
    assert torch.equal(a, before) and np.array_equal(ja_out, before.float().numpy())


# --------------------------------------------------------------------------
# tpu_refview_r5: 16j
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,g,dt", refview_r5.MODES)
def test_refview_vs_jax(monkeypatch, mode, g, dt):
    """16j, bitwise over the whole (64, 128) matrix on random values, and
    the tool's own exact check on zeros.  Mode A's in-kernel reshape of a
    ref is not supported by the Pallas interpreter (``RefReshaper`` has no
    indices), so A is held to the tool's mode D kernel, which computes the
    same function (rows [id*2, id*2+2) += 1 of a bf16 matrix)."""
    tool = _tool("tpu_refview_r5", monkeypatch)
    n, w, e = 64, 128, 4
    for k, v in (("N", n), ("W", w), ("E", e)):
        monkeypatch.setattr(tool, k, v)
    tool.build.cache_clear()
    rng = np.random.default_rng(ord(mode))
    ids = _ids(rng, n // g, e)
    a, ja = _both(rng.standard_normal((n, w)).astype(np.float32), dt)
    with pltpu.force_tpu_interpret_mode():
        fn = tool.build("D" if mode == "A" else mode, g, jnp.dtype(_JDT[dt]).name)
        ref = _run(fn, jnp.asarray(ids), ja)
    tool.build.cache_clear()
    got = refview_r5.refview_rmw(a, torch.from_numpy(ids), g)
    assert np.array_equal(got.float().numpy(), ref)
    z = refview_r5.refview_rmw(torch.zeros((n, w), dtype=dt), torch.from_numpy(ids), g)
    exp = np.zeros((n, w), np.float32)
    for i in ids:
        exp[i * g:(i + 1) * g] += 1.0
    assert np.array_equal(z.float().numpy(), exp)


# --------------------------------------------------------------------------
# tpu_xsel_micro: 16i
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", xsel_micro.MODES)
def test_xsel_vs_jax(monkeypatch, mode):
    """16i, bitwise (extract: fp32 sums in entry order; the others move
    bf16 values): every mode of the tool at E = 16, XW = 128, G = 16 on
    its own inputs (``default_rng(0)``: ids, then x)."""
    tool = _tool("tpu_xsel_micro", monkeypatch)
    e, xw = 16, 128
    monkeypatch.setattr(tool, "E", e)
    monkeypatch.setattr(tool, "XW", xw)
    tool.build.cache_clear()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 16, size=e).astype(np.int32)
    x, jx = _both(rng.standard_normal((16, xw)).astype(np.float32), BF)
    with pltpu.force_tpu_interpret_mode():
        ref = _run(tool.build(mode), jnp.asarray(ids), jx)
    tool.build.cache_clear()
    got = xsel_micro.xsel(x, torch.from_numpy(ids), mode)
    assert np.array_equal(got.numpy(), ref)


# --------------------------------------------------------------------------
# tpu_3d_micro: 16g, 16h
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [BF, torch.float32])
@pytest.mark.parametrize("mode", micro_3d.RELAYOUTS)
def test_relayout_vs_jax(monkeypatch, mode, dt):
    """16g, bitwise: collapse, split and tchunk at c = 8, w = 128."""
    tool = _tool("tpu_3d_micro", monkeypatch)
    c, w = 8, 128
    a, ja = _both(np.random.default_rng(1).standard_normal((2 * c, w)).astype(np.float32), dt)
    inp, jinp = (a, ja) if mode == "split" else (a.view(c, 2, w), ja.reshape(c, 2, w))
    with pltpu.force_tpu_interpret_mode():
        ref = _run(tool.build_copy_reshape(mode, c, w, jnp.dtype(_JDT[dt]).name), jinp)
    assert np.array_equal(micro_3d.relayout(inp, mode).float().numpy(), ref)


@pytest.mark.parametrize("dt", [BF, torch.float32])
@pytest.mark.parametrize("form", micro_3d.FORMS)
def test_gemm3d_vs_jax(monkeypatch, form, dt):
    """16h at s = 16, k = w = 128: the sum order differs, so bf16 within
    one bf16 ulp plus ``utils/oracle.sum_slack`` and fp32 within 1e-6 of
    max |ref| (``micro_3d.gemm3d_close``)."""
    tool = _tool("tpu_3d_micro", monkeypatch)
    s, k, w = 16, 128, 128
    rng = np.random.default_rng(2)
    a, ja = _both(rng.standard_normal((s, k)).astype(np.float32), dt)
    b, jb = _both(rng.standard_normal((k, w)).astype(np.float32), dt)
    c, jc = _both(rng.standard_normal((s, w)).astype(np.float32), dt)
    with pltpu.force_tpu_interpret_mode():
        fn = tool.build_gemm3d(s, k, w, jnp.dtype(_JDT[dt]).name, form)
        ref = _run(fn, ja.reshape(s // 2, 2, k), jb, jc.reshape(s // 2, 2, w))
    ref = torch.from_numpy(ref)
    a3, c3 = a.view(s // 2, 2, k), c.view(s // 2, 2, w)
    got = micro_3d.gemm3d(a3, b, c3)
    assert micro_3d.gemm3d_close(got.float(), ref, a3.float(), b.float(), c3.float())


# --------------------------------------------------------------------------
# tpu_crash_bisect_r5: 16k
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,k,w", [(16, 128, 128), (32, 256, 128)])
def test_dot_vs_jax(monkeypatch, capsys, s, k, w):
    """16k: the tool's ``try_dot`` at a tiny shape (it checks only that the
    output is finite), its kernel captured and run on random bf16
    operands; the port within one bf16 ulp plus ``sum_slack`` of it."""
    tool, spy = _tool("tpu_crash_bisect_r5", monkeypatch, spy=True)
    rng = np.random.default_rng(s + k)
    a, ja = _both(rng.standard_normal((s, k)).astype(np.float32), BF)
    b, jb = _both(rng.standard_normal((k, w)).astype(np.float32), BF)
    with pltpu.force_tpu_interpret_mode():
        assert tool.try_dot(s, k, w)
        ref = torch.from_numpy(_run(spy.fns[-1], ja, jb))
    assert "OK (finite=True)" in capsys.readouterr().out
    got = crash_bisect_r5.dot(a, b)
    assert got.dtype == BF
    assert within_bf16_ulp(got.float(), ref, sum_slack(torch.zeros(()), a, b)).ok


# --------------------------------------------------------------------------
# the port's own entry points, wrappers and bindings on the CPU
# --------------------------------------------------------------------------

_TINY = {
    "probe_r4": lambda: (probe_r4.probe_smem(CPU, sizes=(64, 2048)) + probe_r4.probe_hbm2smem(CPU)
                         + probe_r4.probe_rowdma(CPU, n=256, w=128, nrows=64, depths=(4, 16))
                         + probe_r4.probe_overlap(CPU, ti=16, t=128, kk=128, steps=4,
                                                  extra_mb=(0, 2))),
    "granule_r5": lambda: granule_r5.run(CPU, n=256, w=128, e=8),
    "refview_r5": lambda: refview_r5.run(CPU, n=64, w=128, e=4),
    "xsel_micro": lambda: xsel_micro.run(CPU, e=16, xw=128),
    "micro_3d": lambda: micro_3d.run(CPU, c=8, wc=128, s=16, k=128, wg=128),
    "crash_bisect_r5": lambda: crash_bisect_r5.run(
        CPU, base=(16, 128, 128), legs={"w": [(16, 128, 256)], "s": [(32, 128, 128)],
                                        "k": [(16, 256, 128)]}),
}


@pytest.mark.parametrize("tool", sorted(_TINY))
def test_tool_legs_on_cpu(tool, capsys):
    """Each module's legs at tiny shapes on the CPU: the tool's own checks
    pass on the plain versions, every leg prints one line, and no device
    time is reported (a CPU run measures none)."""
    res = _TINY[tool]()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "ms=" in ln]
    assert res and all(r["ok"] for r in res) and len(lines) == len(res)
    assert all(r["ms"] is None and r["plain_ms"] is None for r in res)
    assert all("ms=not measured" in ln for ln in lines)


def test_main_on_cpu(capsys):
    """``python -m mpf_tpu_torch.tools.probe_r4 smem hbm2smem --device cpu``
    at the tool's own shapes exits 0; a leg that fails makes it exit 1."""
    assert probe_r4.main(["smem", "hbm2smem", "--device", "cpu"]) == 0
    assert "6 of 6 legs OK" in capsys.readouterr().out
    assert probe_r4.finish([{"leg": "x", "ok": False}]) == 1


def test_wrappers_take_the_plain_version_on_cpu():
    """Every probe wrapper on CPU tensors runs its plain version once and
    launches nothing."""
    _lib.reset_counts()
    s, x = torch.arange(2048, dtype=torch.int32), torch.zeros(8, 128)
    probe_r4.sched_read(s, x)
    probe_r4.bulk_copy(s, x)
    probe_r4.row_ring(torch.ones(64, 1, 128), 16, 4)
    lb = torch.ones((16, 16), dtype=BF)
    probe_r4.overlap(lb, lb, torch.zeros((64, 64), dtype=BF), 2, 0.01)
    a = torch.zeros((8, 2, 64), dtype=BF)
    ids = torch.tensor([1, 3, 6], dtype=torch.int32)
    granule_r5.window_rmw(a, ids)
    granule_r5.window_gather(a, ids)
    micro_3d.relayout(a, "collapse")
    micro_3d.gemm3d(a, torch.ones((64, 64), dtype=BF), a)
    xsel_micro.xsel(a.view(16, 64), ids, "dma")
    refview_r5.refview_rmw(a.view(16, 64), ids, 2)
    crash_bisect_r5.dot(lb, lb)
    probes = [k for k in _lib.KERNELS if k.startswith("probe_")]
    assert len(probes) == 11
    assert {k: _lib.plain_calls[k] for k in probes} == {k: 1 for k in probes}
    assert not any(_lib.launches.values())


@pytest.mark.parametrize("call", [
    lambda: granule_r5.window_rmw(torch.zeros((4, 2, 8)), torch.tensor([1]), depth=3),
    lambda: granule_r5.window_gather(torch.zeros((4, 8)), torch.tensor([1])),
    lambda: xsel_micro.xsel(torch.zeros((16, 8), dtype=BF), torch.tensor([1]), "gather"),
    lambda: probe_r4.bulk_copy(torch.arange(16, dtype=torch.int32), torch.zeros(4), 8, 16),
    lambda: probe_r4.overlap(torch.ones((4, 8), dtype=BF), torch.ones((4, 8), dtype=BF),
                             torch.zeros((64, 64), dtype=BF), 1, 0),
    lambda: micro_3d.relayout(torch.zeros((4, 3, 8)), "collapse"),
    lambda: crash_bisect_r5.dot(torch.ones((4, 8)), torch.ones((8, 4))),
    lambda: granule_r5.window_rmw(torch.zeros((4, 2, 8)), torch.tensor([4])),
    lambda: granule_r5.window_gather(torch.zeros((4, 2, 8)), torch.tensor([-1])),
    lambda: xsel_micro.xsel(torch.zeros((16, 8), dtype=BF), torch.tensor([16]), "masked"),
])
def test_bad_arguments_raise(call):
    """Shapes, dtypes, modes and depths the kernels do not take raise
    ValueError, on the CPU as on the card; so do ids outside the windows or
    rows on the CPU (the kernels skip them)."""
    with pytest.raises(ValueError):
        call()


def test_every_entry_point_is_bound():
    """Every ``MPF_API`` function of ``csrc/`` has a ctypes signature in
    ``ops/_lib.py`` with as many arguments as its C declaration (the card
    is the only place the library links, so a missing or short binding
    would show only there)."""
    decl = re.compile(r"MPF_API\s+[\w\s\*]+?\b(mpf_\w+)\s*\(([^)]*)\)", re.S)
    found = {}
    for src in sorted((REPO / "mpf_tpu_torch" / "csrc").glob("*.cu")):
        for name, params in decl.findall(src.read_text()):
            params = params.strip()
            found[name] = 0 if params in ("", "void") else params.count(",") + 1
    assert found and set(found) == set(_lib._SIGS)
    assert {k: len(v) for k, v in _lib._SIGS.items()} == found
