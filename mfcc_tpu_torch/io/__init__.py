"""Host I/O: the wire protocols (``transport``) and their native codecs
(``native``), copies of ``mfcc_tpu.io`` kept here so that the package never
imports JAX.  ``wav`` and ``capture`` come with the CLI."""

from . import transport  # noqa: F401
