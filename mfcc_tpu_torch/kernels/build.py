"""Build and bind the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, at first use, into ``mfcc_tpu_torch/_build/``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/libmfcc_kernels-<hash>.so csrc/*.cu

The file name carries a hash of the sources and the flags, so an edited
source is rebuilt and a stale library is never loaded.  The library is
loaded with ``ctypes`` and each entry point gets its ``argtypes`` and
``restype``.  No ``--use_fast_math``: it turns ``log2f`` into ``__log2f``
and flushes denormals, which the float gate does not allow.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# mfcc_fladder_{i16,f32}(audio, out, S, T, F, hop, nfft, nfilters, ncep,
#                        win, tw, mel, dct, band, mel_floor, stream)
_FLADDER_ARGS = [_P, _P, _LL, _LL, _I, _I, _I, _I, _I,
                 _P, _P, _P, _P, _P, ctypes.c_double, _P]
SIGNATURES = {
    "mfcc_fladder_i16": _FLADDER_ARGS,
    "mfcc_fladder_f32": _FLADDER_ARGS,
}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built from source at first use")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every csrc file (.cu and .cuh) and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for the current sources exists;
    return the library's path.  Raises with nvcc's output on failure."""
    lib = BUILD_DIR / f"libmfcc_kernels-{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sources())]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(f"nvcc built {lib.name} in {time.perf_counter() - t0:.1f} s\n"
              f"{res.stdout}{res.stderr}", flush=True)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
