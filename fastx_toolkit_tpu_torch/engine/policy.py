"""One engine-dispatch policy for every dual-engine surface.

Counterpart of ``fastx_toolkit_tpu/engine/policy.py``.  Several tools
have two byte-identical engines — a fused host-native C++ pass and a
device pass — and the default depends on where the device sits, not on
the tool.  The kinds are the reference's:

* ``stats``      — fastx_quality_stats histogram accumulation
                   (``ops/stats.py``: the native ``fx_stats_lines_q`` vs
                   the histogram kernel K5);
* ``collapse``   — fastx_collapser dedup;
* ``per-read``   — the per-read CLI tools' raw-line fast path vs the
                   classic parse -> device path.

Policy (the auto mode), the reference's rule for a chip on the host's
own bus:

* **a local CUDA card** (``FASTX_TORCH_DEVICE`` resolves to ``cuda``) ->
  ``device`` for the reductions (stats, collapse);
* **the CPU** -> ``host`` whenever the native codec is available;
* **per-read tools** -> ``host`` everywhere;
* without the native codec, ``device`` (its plain torch versions on the
  CPU).

A surface's env override (``FASTX_STATS_PATH`` for the stats CLI) goes
through :func:`resolve` on top of this shared auto.  Whether the device
rule still holds on the H100 is measured, not assumed: ``chip_smoke.py``
times both engines of the stats CLI.
"""

from __future__ import annotations

_KINDS = ("stats", "collapse", "per-read")


def backend_kind() -> str:
    """``'gpu-local'`` when the resolved torch device is CUDA, else
    ``'cpu'`` (``device.resolve_device``, which raises when CUDA is asked
    for and absent)."""
    from ..device import resolve_device

    return "gpu-local" if resolve_device().type == "cuda" else "cpu"


def engine_auto(kind: str) -> str:
    """'host' or 'device' for a dual-engine surface (the shared auto
    policy; see the module docstring)."""
    from ..core import native

    if kind not in _KINDS:
        raise ValueError("unknown engine kind %r" % (kind,))
    if native.LIB is None:
        return "device"
    if kind == "per-read":
        return "host"
    return "device" if backend_kind() == "gpu-local" else "host"


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
