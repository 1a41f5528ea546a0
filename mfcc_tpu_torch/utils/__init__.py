from . import debug, liftering, vad  # noqa: F401
