"""The port's own host codec.

FASTA/FASTQ framing, validation, 2-bit packing, rendering and the float32
clipper DP: numpy (``codec.py``, ``records.py``) and C++
(``native/fastx_codec.cpp``, built with g++ into ``_build/`` at first
import by ``native.py``).  These are copies of the reference package's
``core/`` modules and ``native/`` codec, verbatim apart from imports and
paths, so framing, validation, packing, rendering and ``clip_float``
behave byte for byte as there; the port imports nothing of the reference
package.
"""

from . import codec, native  # noqa: F401
from .errors import FastxError  # noqa: F401
from .records import BaseCode, ReadBatch  # noqa: F401
