"""ctypes binding to the native host runtime (native/mfcc_host.cpp).

Builds the shared library on first use if the toolchain is available;
callers fall back to pure-Python paths when it is not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libmfcc_host.so"))

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        lib = ctypes.CDLL(_LIB_PATH)

        lib.mfcc_free.argtypes = [ctypes.c_void_p]
        lib.mfcc_wav_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.mfcc_wav_read.restype = ctypes.c_int
        lib.mfcc_wav_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32]
        lib.mfcc_wav_read_batch.restype = ctypes.c_int
        lib.mfcc_encode_stream_words.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.mfcc_encode_stream_words.restype = ctypes.c_int64
        lib.mfcc_decode_stream_words.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8)]
        lib.mfcc_decode_stream_words.restype = ctypes.c_int64
        lib.mfcc_magic_sync.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.c_int64]
        lib.mfcc_magic_sync.restype = ctypes.c_int64
        lib.mfcc_encode_frames.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.mfcc_encode_frames.restype = ctypes.c_int64
        lib.mfcc_decode_frames.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.mfcc_decode_frames.restype = ctypes.c_int64

        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def wav_read(path: str):
    """Decode a wav via the native decoder -> (samples int16, rate)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64()
    rate = ctypes.c_int32()
    rc = lib.mfcc_wav_read(path.encode(), ctypes.byref(out), ctypes.byref(n),
                           ctypes.byref(rate))
    if rc != 0:
        raise IOError(f"mfcc_wav_read({path}) failed with {rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.mfcc_free(out)
    return arr, rate.value


def wav_read_batch(paths: list[str], max_samples: int, n_threads: int = 0):
    """Threaded batch decode -> (matrix (N, max_samples) int16, lengths,
    rates).  The native data loader feeding the TPU batch pipeline."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    out = np.zeros((n, max_samples), dtype=np.int16)
    lengths = np.zeros(n, dtype=np.int64)
    rates = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.mfcc_wav_read_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        max_samples, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if rc != 0:
        raise IOError(f"mfcc_wav_read_batch failed with {rc}")
    return out, lengths, rates


def encode_frames(cep: np.ndarray) -> bytes:
    """(F, ncep) int16 -> magic-framed big-endian byte stream (native)."""
    lib = load()
    cep = np.ascontiguousarray(cep, dtype=np.int16)
    F, ncep = cep.shape
    out = np.zeros(F * (2 + 2 * ncep), dtype=np.uint8)
    n = lib.mfcc_encode_frames(
        cep.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), F, ncep,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:n].tobytes()


def decode_frames(data: bytes, ncep: int, max_frames: int = 1 << 20):
    """Magic-framed byte stream -> ((F, ncep) int16, consumed bytes)."""
    lib = load()
    buf = np.frombuffer(data, dtype=np.uint8)
    cep = np.zeros((max_frames, ncep), dtype=np.int16)
    consumed = ctypes.c_int64()
    n = lib.mfcc_decode_frames(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf), ncep,
        cep.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), max_frames,
        ctypes.byref(consumed))
    return cep[:n].copy(), consumed.value
