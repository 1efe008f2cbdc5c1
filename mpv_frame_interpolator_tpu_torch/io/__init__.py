"""Host IO of the port: synthetic sources, the seekable y4m reader and
writer and the raw I420 reader, the page-locked buffer pool the readers
fill, and the frame sinks."""

import contextlib
import errno
import struct


@contextlib.contextmanager
def corrupt_as(error: type):
    """Re-raise what a container parser meets in a damaged file -- a field
    cut short by the file's end (``struct.error``), an offset past what
    any file can hold (``OverflowError``, or ``EINVAL`` from a seek) -- as
    the format's own `error`, a ``ValueError``."""
    try:
        yield
    except (struct.error, OverflowError) as e:
        raise error(f"truncated or corrupt file: {e}") from e
    except OSError as e:
        if e.errno != errno.EINVAL:
            raise
        raise error(f"offset out of range: {e}") from e
