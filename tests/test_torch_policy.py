"""The port's engine policy (``engine/policy.py``): the host engine for
every kind wherever the native codec is, on a card as on the CPU (the
H100's ten alternating pairs a kind, ``profile_paths.py --policy``), the
device engine without it; the env overrides on top, as in the
reference's ``resolve``."""

import pytest

from fastx_toolkit_tpu_torch.core import native
from fastx_toolkit_tpu_torch.engine import policy

KINDS = ("stats", "collapse", "per-read")


@pytest.mark.parametrize("kind", KINDS)
def test_auto_is_host_with_the_native_codec_else_device(kind, monkeypatch):
    monkeypatch.setattr(native, "LIB", object())
    assert policy.engine_auto(kind) == "host"
    assert policy.resolve(kind, None) == "host"
    assert policy.resolve(kind, "bogus") == "host"
    assert policy.resolve(kind, "device") == "device"
    monkeypatch.setattr(native, "LIB", None)
    assert policy.engine_auto(kind) == "device"
    assert policy.resolve(kind, "device") == "device"
    with pytest.raises(RuntimeError, match="requires the native codec"):
        policy.resolve(kind, "host")


def test_auto_needs_no_device(monkeypatch):
    """The default is decided without resolving the torch device, so a
    missing card cannot change which engine runs."""
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cuda:7")
    monkeypatch.setattr(native, "LIB", object())
    assert {policy.engine_auto(k) for k in KINDS} == {"host"}


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown engine kind"):
        policy.engine_auto("barcodes")
