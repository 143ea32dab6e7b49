"""Environment knobs of the driver (counterpart of `mpf_tpu/config.py:41-63`
and the env reads of `mpf_tpu/models/mpf.py:_resolve_super` and
`_resolve_defer`).  Plain functions; nothing here imports JAX.

* ``MPF_XCHG`` — :func:`combined_exchange`: ``combined`` (default, kernel 4)
  or ``split`` (kernel 11: a gather launch, then a scatter from the band).
* ``MPF_LOOKAHEAD`` — :func:`lookahead`: ``1`` runs the one-deep lookahead
  driver; anything else (default ``auto``) does not.
* ``MPF_SUPER`` — :func:`super_block`: superblock width (``0``/``none``
  disables, ``auto`` is disabled).
* ``MPF_DEFER`` — :func:`resolve_defer`: the deferred-overflow exchange's
  group size S (``0`` off, ``auto``, or an int); ``defer=True`` takes
  ``MPF_DEFER_S`` (default 8), ``auto`` takes ``MPF_DEFER_AUTO_S`` (unset:
  off), which the driver keeps only where :func:`defer_is_auto` lets its
  size rule decide (`models/mpf.py:_resolve_defer`).

An explicit argument wins over its env knob (for ``super_block`` the
default ``"auto"`` defers to ``MPF_SUPER``; the JAX package lets
``MPF_SUPER`` override even an explicit width).  :func:`mpf_factorize`
reads the env at each call, :func:`make_mpf` once, when it builds the
factorizer, as the JAX package freezes its knobs at the first trace.

``MPF_USE_PALLAS``, ``MPF_FORCE_KERNELS``, ``MPF_ABLATE`` and
``MPF_U12_PREC`` have no counterpart: the port picks kernels by the
tensor's device and computes U12 in IEEE fp32.
"""

from __future__ import annotations

import os


def combined_exchange() -> bool:
    """``MPF_XCHG``: True for the combined row exchange (default), False
    for ``split``."""
    return os.environ.get("MPF_XCHG", "combined") != "split"


def lookahead(explicit: bool | None = None) -> bool:
    """``explicit`` if given, else ``MPF_LOOKAHEAD == "1"``."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get("MPF_LOOKAHEAD", "auto") == "1"


def super_block(explicit="auto") -> int | None:
    """The requested superblock width before the shape checks of
    ``_resolve_super``: ``explicit`` unless it is ``"auto"``, then
    ``MPF_SUPER`` (unset, ``0``, ``none`` or ``auto``: disabled)."""
    if explicit != "auto":
        return explicit
    env = os.environ.get("MPF_SUPER", "")
    if env in ("", "0", "none", "auto"):
        return None
    return int(env)


def _defer_value(defer):
    if defer is None:
        env = os.environ.get("MPF_DEFER", "auto")
        defer = {"0": False, "auto": "auto"}.get(env, env)
    return defer


def defer_is_auto(defer=None) -> bool:
    """True when ``defer`` (or, for None, ``MPF_DEFER``) is ``auto``."""
    return _defer_value(defer) == "auto"


def resolve_defer(defer=None, pivot: bool = True) -> int:
    """The requested deferred-exchange group size S before the driver's
    shape checks, or 0 (off), as `mpf_tpu/models/mpf.py:859-907` reads it:
    ``defer=S``; ``defer=True``: ``MPF_DEFER_S`` (default 8);
    ``defer=None``: ``MPF_DEFER`` (``0`` off, ``auto``, or an int S);
    ``auto``: ``MPF_DEFER_AUTO_S`` (unset: 0).  ``False``, ``0`` and
    ``pivot=False`` resolve to 0."""
    defer = _defer_value(defer)
    if defer is False or not pivot:
        return 0
    if defer == "auto":
        s = int(os.environ.get("MPF_DEFER_AUTO_S") or 0)
    elif defer is True:
        s = int(os.environ.get("MPF_DEFER_S", "8"))
    else:
        s = int(defer)
    return max(s, 0)
