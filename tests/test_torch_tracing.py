"""The block-column loop's stage spans (`_lib.span`) and counters on every
driver route, on the CPU at n = 256 (block 64, r = 32: 4 block columns of
2 r-panels).

Under ``torch.profiler`` each stage is a ``record_function`` range: the
counts below follow from the route and the shape, ``mpf.update`` (and on
the masked path ``mpf.prepivot``, ``mpf.swap`` and ``mpf.npv``) sits in
``mpf.panel``, and every operator of the factorization but the set-up
before the loop lies inside a stage; on the masked path every operator of
an r-panel lies in one of its four stages.  With no profiler recording no
range is built, and the factors are the same bits either way."""

import collections
import functools
import os

import pytest
import torch

import mpf_tpu_torch as T
from mpf_tpu_torch.models import mpf as TM
from mpf_tpu_torch.ops import _lib

N, BLOCK, R = 256, 64, 32
NBC, NPANELS = N // BLOCK, N // R
#: the set-up before the loop: ``ipiv`` and ``perm`` (arange), ``info`` (zeros)
SETUP = {"aten::arange": 2, "aten::zeros": 1}
#: the deferred exchange's extended buffer, its copy of the input, the view
#: of its first n rows that is returned, and the row-to-position map
DEFER_SETUP = {"aten::arange": 3, "aten::zeros": 1, "aten::empty": 1, "aten::slice": 2,
               "aten::copy_": 1, "aten::full": 1, "aten::cat": 1}
#: the pair layout's (n, n) view of the (n/2, 2, n) input
PAIRS_SETUP = dict(SETUP, **{"aten::view": 1})

#: the stages of a block column that sit inside its ``mpf.panel``
PANEL_STAGES = ("mpf.update", "mpf.prepivot", "mpf.swap", "mpf.npv")
#: a masked block column's own operators in ``mpf.panel``, outside its
#: panels' stages: ``perm`` and ``piv_all`` (arange, add), ``info`` (zeros),
#: the ``ipiv`` write (slice, add, copy_) and the ``info`` merge
MASKED_OWN = {"aten::arange": 2, "aten::add": 2, "aten::zeros": 1, "aten::slice": 2,
              "aten::copy_": 1, "aten::eq": 1, "aten::gt": 1, "aten::__and__": 1,
              "aten::where": 1}
#: the masked path's stages a pivoted r-panel opens
MASKED = dict(prepivot=NPANELS, swap=NPANELS, npv=NPANELS)

#: route -> (policy, options, path, setup, stage counts).  Updates follow
#: every block column but the last (3); the lookahead driver splits the
#: first two at the next block column's edge (3 narrow + 2 wide); the
#: superblock driver (S = 128) runs a mid update in block columns 0 and 2
#: and one far update; the deferred exchange (groups of 2) adds a flush a
#: group to the 4 exchanges; an unpivoted block column exchanges no rows,
#: and its r-panels search no pivots and swap no rows.
ROUTES = {
    "fused_mpf_bf16": (T.MPF_BF16, {}, "fused", SETUP, dict(exchange=4, u12=3, trailing=3)),
    "fused_all_bf16": (T.ALL_BF16, {}, "fused", SETUP, dict(exchange=4, u12=3, trailing=3)),
    "masked_mpf_fp16": (T.MPF_FP16, {}, "masked", SETUP,
                        dict(exchange=4, u12=3, trailing=3, **MASKED)),
    "masked_unpivoted": (T.MPF_BF16, {"pivot": False}, "masked", SETUP,
                         dict(exchange=0, u12=3, trailing=3, npv=NPANELS)),
    "lookahead": (T.MPF_BF16, {"lookahead": True}, "fused", SETUP,
                  dict(exchange=4, u12=5, trailing=5)),
    "deferred": (T.MPF_BF16, {"defer": 2}, "fused", DEFER_SETUP,
                 dict(exchange=6, u12=3, trailing=3)),
    "superblock": (T.MPF_BF16, {"super_block": 128}, "fused", SETUP,
                   dict(exchange=4, u12=3, trailing=3)),
    "pairs": (T.MPF_BF16, {}, "fused", PAIRS_SETUP, dict(exchange=4, u12=3, trailing=3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: the plain versions issue thousands of small
    ops, between which idle OpenMP workers would spin on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for key in [k for k in os.environ if k.startswith("MPF_")]:
        monkeypatch.delenv(key)


def _matrix(route):
    """U[0, 1): pivots move on nearly every column, so every stage works."""
    pol = ROUTES[route][0]
    g = torch.Generator().manual_seed(7)
    a = torch.rand(N, N, generator=g).to(pol.working)
    return a.view(N // 2, 2, N) if route == "pairs" else a


def _factor(route, a):
    pol, opts = ROUTES[route][:2]
    return TM.mpf_factorize_inplace(a, r=R, policy=pol, block=BLOCK, **opts)


def _span_of(ev):
    """The name of the innermost stage span around ``ev``, or None."""
    p = ev.cpu_parent
    while p is not None:
        if p.name.startswith("mpf."):
            return p.name
        p = p.cpu_parent
    return None


def _has_span_ancestor(ev) -> bool:
    return _span_of(ev) is not None


@functools.lru_cache(maxsize=None)
def _traced(route):
    """The route factored once under the profiler and once without it:
    ``(traced result, untraced result, events, counters of the traced run,
    its kernel launches and plain calls)``."""
    _lib.reset_counts()
    a = _matrix(route)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = _factor(route, a)
    counts = (dict(_lib.block_columns), dict(_lib.panels))
    calls = (dict(_lib.launches), dict(_lib.plain_calls))
    off = _factor(route, _matrix(route))
    return on, off, list(prof.events()), counts, calls


@pytest.mark.parametrize("route", ROUTES)
def test_span_tree(route):
    setup, stages = ROUTES[route][3], ROUTES[route][4]
    events = _traced(route)[2]
    spans = [e for e in events if e.name.startswith("mpf.")]
    want = dict(stages, panel=NBC, update=NPANELS)
    assert collections.Counter(e.name for e in spans) == {
        f"mpf.{k}": v for k, v in want.items() if v}
    for e in spans:
        if e.name in PANEL_STAGES:
            assert e.cpu_parent is not None and e.cpu_parent.name == "mpf.panel"
        else:  # the stages of a block column do not nest in one another
            assert not _has_span_ancestor(e), e.name
    first = min(e.time_range.start for e in spans)
    outside = [e for e in events if e.name.startswith("aten::") and not _has_span_ancestor(e)]
    # operators outside every stage are the set-up, all before the loop
    assert all(e.time_range.end <= first for e in outside)
    top = [e for e in outside
           if e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")]
    assert collections.Counter(e.name for e in top) == setup


@pytest.mark.parametrize("route", ROUTES)
def test_same_answer_traced_and_not(route):
    on, off = _traced(route)[:2]
    for x, y in zip(on, off):
        assert torch.equal(x, y)
    assert int(on.info) == 0


@pytest.mark.parametrize("route", ROUTES)
def test_block_column_counters(route):
    path = ROUTES[route][2]
    other = "masked" if path == "fused" else "fused"
    block_columns, panels = _traced(route)[3]
    assert block_columns == {path: NBC, other: 0}
    assert panels == {path: NPANELS, other: 0}
    _lib.reset_counts()
    assert _lib.block_columns == {"fused": 0, "masked": 0}
    assert _lib.panels == {"fused": 0, "masked": 0}


@pytest.mark.parametrize("route", ["masked_mpf_fp16", "masked_unpivoted"])
def test_masked_panel_lies_in_its_stages(route):
    """Of the operators in ``mpf.panel`` and in no stage inside it, none is
    an r-panel's: they are each block column's own set-up and ``ipiv`` /
    ``info`` writes, the same in every block column."""
    events = _traced(route)[2]
    own = [e for e in events if e.name.startswith("aten::") and _span_of(e) == "mpf.panel"
           and not e.cpu_parent.name.startswith("aten::")]
    assert collections.Counter(e.name for e in own) == {k: v * NBC for k, v in MASKED_OWN.items()}


@pytest.mark.parametrize("route", ["masked_mpf_fp16", "masked_unpivoted"])
def test_masked_kernel_calls(route):
    """Per factorization on the CPU: kernel 7 (``hgetf2``) and kernel 8
    (``npv_inv``) once an r-panel, kernel 9 (``laswp``) once a pivoted
    r-panel on the slab and once for each side of a block column with
    columns there (1 + 2 + 2 + 1); plain versions only, no launch."""
    launches, plain = _traced(route)[4]
    pivot = ROUTES[route][1].get("pivot", True)
    assert plain["hgetf2"] == (NPANELS if pivot else 0)
    assert plain["npv_inv"] == NPANELS
    assert plain["laswp"] == (NPANELS + 2 * NBC - 2 if pivot else 0)
    assert not any(launches.values())


@pytest.mark.parametrize("route", ["fused_mpf_bf16", "masked_mpf_fp16", "lookahead",
                                   "deferred", "superblock", "pairs"])
def test_no_range_built_without_a_profiler(route, monkeypatch):
    want = _traced(route)[1]

    def refuse(*_args, **_kw):
        raise AssertionError("record_function built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    res = _factor(route, _matrix(route))
    assert torch.equal(res.lu, want.lu) and torch.equal(res.ipiv, want.ipiv)
