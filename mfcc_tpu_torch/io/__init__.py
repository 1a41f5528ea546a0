"""Host I/O: wav ingestion (``wav``), the wire protocols (``transport``),
their native codecs (``native``) and live capture (``capture``), copies of
``mfcc_tpu.io`` kept here so that the package never imports JAX."""

from . import wav, transport  # noqa: F401
