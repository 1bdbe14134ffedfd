"""Error type mirroring the reference's fail-fast errx(1, ...) behavior.

The reference C tools abort with ``errx(1, fmt, ...)`` which prints
``<progname>: <message>`` to stderr and exits with status 1
(see FASTX-Toolkit src/libfastx/fastx.c error paths).  The CLI layer
catches :class:`FastxError` and reproduces that exactly.
"""


class FastxError(Exception):
    """Fatal input/usage error; message text matches the reference tools."""

    def __init__(self, message: str, status: int = 1):
        super().__init__(message)
        self.status = status
