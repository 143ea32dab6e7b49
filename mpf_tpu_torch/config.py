"""Environment knobs of the driver (counterpart of `mpf_tpu/config.py:41-63`
and the env reads of `mpf_tpu/models/mpf.py:_resolve_super` and
`_resolve_defer`).  Plain functions; nothing here imports JAX.

* ``MPF_XCHG`` — :func:`combined_exchange`: ``combined`` (default, kernel 4)
  or ``split`` (kernel 11: a gather launch, then a scatter from the band).
* ``MPF_LOOKAHEAD`` — :func:`lookahead`: ``1`` runs the one-deep lookahead
  driver; anything else (default ``auto``) does not.
* ``MPF_SUPER`` — :func:`super_block`: superblock width (``0``/``none``
  disables, ``auto`` is disabled).
* ``MPF_DEFER`` — :func:`resolve_defer`: the deferred-overflow exchange is
  not ported; asking for a group size S > 0 raises.

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


def resolve_defer(defer=None, pivot: bool = True) -> int:
    """The deferred-exchange group size, which is always 0 here: raises
    ``NotImplementedError`` where a group size S > 0 is asked for
    (``defer=S``, ``defer=True`` with ``MPF_DEFER_S``, default 8, or
    ``defer=None`` with ``MPF_DEFER=<int>``), as the JAX package would then
    start its deferred driver.  ``auto``, ``0``, ``False`` and
    ``pivot=False`` resolve to 0, as there."""
    if defer is None:
        env = os.environ.get("MPF_DEFER", "auto")
        defer = {"0": False, "auto": "auto"}.get(env, env)
    if defer is False or defer == "auto" or not pivot:
        return 0
    s = int(os.environ.get("MPF_DEFER_S", "8")) if defer is True else int(defer)
    if s > 0:
        raise NotImplementedError(
            f"defer (deferred-overflow exchange, group size {s}) is not ported to "
            "mpf_tpu_torch yet (ROADMAP.md: Queue 1, deferred exchange)")
    return 0
