"""One engine-dispatch policy for every dual-engine surface.

Counterpart of ``fastx_toolkit_tpu/engine/policy.py``.  Several tools
have two byte-identical engines — a fused host-native C++ pass and a
device pass — and one rule picks the default for all of them.  The kinds
are the reference's:

* ``stats``      — fastx_quality_stats histogram accumulation
                   (``ops/stats.py``: the native ``fx_stats_lines_q`` vs
                   the histogram kernel K5);
* ``collapse``   — fastx_collapser dedup;
* ``per-read``   — the per-read CLI tools' raw-line fast path vs the
                   classic parse -> device path.

Policy (the auto mode): ``host`` for every kind whenever the native
codec is available, else ``device`` (its plain torch versions on the
CPU).  The reference puts the reductions (stats, collapse) on the device
when the chip sits on the host's own bus; on one H100 (700 W) the host
engine won every one of ten alternating pairs for each kind on 1M-read
lanes, by 1.76x (stats) and 3.27x (collapse) in the medians, and the
raw-line path by 1.87-2.20x for each of the six per-read tools
(``python -m fastx_toolkit_tpu_torch.profile_paths --policy``): parsing
and uploading the blocks costs more than the card saves.

A surface's env override (``FASTX_STATS_PATH``, ``FASTX_COLLAPSE_PATH``,
``FASTX_LINEPATH``) goes through :func:`resolve` on top of this auto.
"""

from __future__ import annotations

_KINDS = ("stats", "collapse", "per-read")


def engine_auto(kind: str) -> str:
    """'host' or 'device' for a dual-engine surface (the shared auto
    policy; see the module docstring)."""
    from ..core import native

    if kind not in _KINDS:
        raise ValueError("unknown engine kind %r" % (kind,))
    return "device" if native.LIB is None else "host"


def resolve(kind: str, override: str | None) -> str:
    """Apply an explicit override ('host'/'device') over the auto policy.

    Unrecognized override strings fall back to auto (a typo'd env var must
    not crash a streaming tool); a forced host engine without the native
    library is the one hard error."""
    from ..core import native

    if override == "host":
        if native.LIB is None:
            raise RuntimeError(
                "engine override 'host' for %s requires the native codec "
                "library" % kind
            )
        return "host"
    if override == "device":
        return "device"
    return engine_auto(kind)
