"""The host codec the port shares with the reference.

FASTA/FASTQ framing, validation, 2-bit packing, rendering and the float32
clipper DP are framework-free numpy and C++ in the reference package
(``fastx_toolkit_tpu/core``, ``native/fastx_codec.cpp``); the port uses
them as they are, through this one module, so that no port module
reaches into the reference for anything that imports jax.
"""

from fastx_toolkit_tpu.core import codec, native  # noqa: F401
from fastx_toolkit_tpu.core.errors import FastxError  # noqa: F401
