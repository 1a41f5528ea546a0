"""Build and bind the package's CUDA kernels.

Each ``csrc/*.cu`` file (each may include the ``csrc/*.cuh`` headers) is
compiled by ``nvcc`` into a shared library with a plain C interface, at
first use, into ``mfcc_tpu_torch/_build/``; the ``nvcc`` calls, one per
source, are started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file names carry a hash of the sources and the flags, so an edited
source is rebuilt and a stale library is never loaded.  The libraries are
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
import types
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# the FP64 tail's tables (ops/fladder.tail_tables): win, tw, mel, dct, band,
# the mel schedule (pointer) and its steps a lane
_TAIL_TABLES = [_P] * 6 + [_I]
# mfcc_tail_walk(ingest, in_i16, in, out, S, T, F, hop, nfft, wlen, emph,
#                nfilters, ncep, <tail tables>, mel_floor, wire_grid, stream)
_TAIL_WALK_ARGS = ([_I, _I, _P, _P, _LL, _LL, _I, _I, _I, _I,
                    ctypes.c_double, _I, _I] + _TAIL_TABLES
                   + [ctypes.c_double, _I, _P])
# mfcc_int_{i16,i32}(audio, out, S, T, F, hop, nfilters, ncep, fb_shift,
#                    log_precision, log_width, curve, tw, dtw, sched,
#                    stream)
_INT_AUDIO_ARGS = [_P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P]
# mfcc_int_frames_i32(frames, out, M, nfilters, ncep, fb_shift,
#                     log_precision, log_width, curve, tw, dtw, sched,
#                     stream)
_INT_FRAMES_ARGS = [_P, _P, _LL, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P]
# mfcc_stream_f32_{i16,f32}(carry, chunk, count, reset, prev, out, mask,
#                           ncarry, ncount, nprev, S, P, C, F, hop, nfft,
#                           nfilters, ncep, carry_s, carry_p, chunk_s,
#                           chunk_t, ncarry_s, ncarry_p, <tail tables>,
#                           mel_floor, stream)
_STREAM_F32_ARGS = ([_P] * 10 + [_LL] + [_I] * 7 + [_LL] * 6 + _TAIL_TABLES
                    + [ctypes.c_double, _P])
# mfcc_stream_int_{i16,i32}(carry, chunk, count, reset, prev, out, mask,
#                           ncarry, ncount, nprev, S, P, C, F, hop, carry_s,
#                           carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p,
#                           nfilters, ncep, fb_shift, log_precision,
#                           log_width, curve, tw, dtw, sched, stream)
_STREAM_INT_ARGS = ([_P] * 10 + [_LL] + [_I] * 4 + [_LL] * 6 + [_I] * 5
                    + [_P] * 5)
# the product engine's operator (ops/dmma_product.Operator.args): op,
# op_rows, chunk_rows
_ENGINE = [_P] + [_I] * 2
# the split-DFT tables of K5: we, wo, tw, mel weights, mel offsets, dct,
# band (pointers), mel length
_R2_TABLES = [_P] * 7 + [_I]
# mfcc_radix2_{i16,f32}(audio, out, S, T, F, hop, nfft, nfilters, ncep,
#                       passes, <engine>, <tables>, mel_floor, stream)
_RADIX2_ARGS = ([_P, _P, _LL, _LL] + [_I] * 6 + _ENGINE + _R2_TABLES
                + [ctypes.c_double, _P])
# mfcc_frames_float_f32(frames, out, M, nfft, nfilters, ncep, passes,
#                       <engine>, <tables>, mel_floor, stream)
_FRAMES_FLOAT_ARGS = ([_P, _P, _LL] + [_I] * 4 + _ENGINE + _R2_TABLES
                      + [ctypes.c_double, _P])
# mfcc_stream_r2_{i16,f32}(carry, chunk, start, prev, out, ncarry, S, P, C,
#                          F, hop, nfft, nfilters, ncep, carry_s, carry_p,
#                          chunk_s, chunk_t, ncarry_s, ncarry_p, passes,
#                          <engine>, <tables>, mel_floor, stream)
_STREAM_R2_ARGS = ([_P] * 6 + [_LL] + [_I] * 7 + [_LL] * 6 + [_I]
                   + _ENGINE + _R2_TABLES + [ctypes.c_double, _P])
# mfcc_int_front_i16(audio, power, S, T, F, hop, curve, tw, stream)
_INT_FRONT_ARGS = [_P, _P, _LL, _LL, _I, _I, _P, _P, _P]
# mfcc_int_epi(power, out, M, nfilters, ncep, fb_shift, log_precision,
#              log_width, dtw, sched, stream)
_INT_EPI_ARGS = [_P, _P, _LL, _I, _I, _I, _I, _I, _P, _P, _P]
# mfcc_dense_{i16,f32}(audio, out, S, T, F, hop, nfft, nfilters, ncep,
#                      ingest, split, <engine>, mel weights, mel offsets,
#                      dct, band, mel length, mel_floor, stream)
_DENSE_ARGS = ([_P, _P, _LL, _LL] + [_I] * 7 + _ENGINE + [_P] * 4 + [_I]
               + [ctypes.c_double, _P])
# mfcc_dense_smem(nfft, hop, nfilters, ncep, mel length, ingest, <engine>,
#                 smem*, stages*)
_DENSE_SMEM_ARGS = [_I] * 6 + _ENGINE + [_P, _P]
# mfcc_radix2_smem(nfft, nfilters, ncep, mel length, passes, <engine>,
#                  smem*, stages*)
_RADIX2_SMEM_ARGS = [_I] * 5 + _ENGINE + [_P, _P]
# whisper_logmel(in_i16, in, out, tile_max, B, T, F, hop, nfilters, win, tw,
#                msched, msteps, silent, stream)
_WHISPER_LOGMEL_ARGS = [_I, _P, _P, _P, _LL, _LL, _I, _I, _I, _P, _P, _P, _I,
                        _P, _P]
# whisper_norm(out, tile_max, B, nfilters, F, tpw, range, stream)
_WHISPER_NORM_ARGS = [_P, _P, _LL, _I, _I, _I, ctypes.c_double, _P]
# seamless_fbank(in_i16, in, lnmel, out, mask, starts, B, T, Fpad, frames,
#                hop, nfft, wlen, emph, nfilters, win, tw, mel, band, msched,
#                msteps, mel_floor, var_floor, stream)
_SEAMLESS_FBANK_ARGS = ([_I] + [_P] * 5 + [_LL, _LL, _I, _LL, _I, _I, _I,
                        ctypes.c_double, _I] + [_P] * 5
                        + [_I, ctypes.c_double, ctypes.c_double, _P])
SIGNATURES = {
    "mfcc_tail_walk": _TAIL_WALK_ARGS,
    "mfcc_radix2_i16": _RADIX2_ARGS,
    "mfcc_radix2_f32": _RADIX2_ARGS,
    "mfcc_frames_float_f32": _FRAMES_FLOAT_ARGS,
    "mfcc_stream_r2_i16": _STREAM_R2_ARGS,
    "mfcc_stream_r2_f32": _STREAM_R2_ARGS,
    "mfcc_int_i16": _INT_AUDIO_ARGS,
    "mfcc_int_i32": _INT_AUDIO_ARGS,
    "mfcc_int_frames_i32": _INT_FRAMES_ARGS,
    "mfcc_stream_f32_i16": _STREAM_F32_ARGS,
    "mfcc_stream_f32_f32": _STREAM_F32_ARGS,
    "mfcc_stream_int_i16": _STREAM_INT_ARGS,
    "mfcc_stream_int_i32": _STREAM_INT_ARGS,
    # mfcc_stream_staged(int_step, F, C, nfft, in_bytes, carry_s, carry_p,
    #                    chunk_s, chunk_t): 1 where K4 takes the staged window
    "mfcc_stream_staged": [_I, _I, _I, _I, _I, _LL, _LL, _LL, _LL],
    "mfcc_int_front_i16": _INT_FRONT_ARGS,
    "mfcc_int_epi": _INT_EPI_ARGS,
    "mfcc_dense_i16": _DENSE_ARGS,
    "mfcc_dense_f32": _DENSE_ARGS,
    "mfcc_dense_smem": _DENSE_SMEM_ARGS,
    "mfcc_radix2_smem": _RADIX2_SMEM_ARGS,
    "whisper_logmel": _WHISPER_LOGMEL_ARGS,
    "whisper_norm": _WHISPER_NORM_ARGS,
    "seamless_fbank": _SEAMLESS_FBANK_ARGS,
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


def build(verbose: bool = False) -> list[Path]:
    """Compile every source whose library for the current sources does not
    exist, all in parallel; return the libraries' paths.  Raises with
    nvcc's output on failure."""
    digest = source_hash()
    libs = [BUILD_DIR / f"lib{src.stem}-{digest}.so" for src in sources()]
    t0 = time.perf_counter()
    jobs = []
    for src, lib in zip(sources(), libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    outs = [proc.communicate() for *_, proc in jobs]   # wait for every one
    for (cmd, tmp, lib, proc), (out, err) in zip(jobs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
        if verbose:
            print(f"nvcc built {lib.name}\n{out}{err}", flush=True)
        os.replace(tmp, lib)
    if verbose and jobs:
        print(f"nvcc: {len(jobs)} sources in parallel, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return libs


@functools.lru_cache(maxsize=None)
def library() -> types.SimpleNamespace:
    """Every entry point of the built libraries, its signature declared."""
    libs = [ctypes.CDLL(str(path)) for path in build()]
    fns = {}
    for name, args in SIGNATURES.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(**fns)


def launch(fn, device, *args) -> None:
    """Call the C entry point ``fn`` on ``device`` and its current stream,
    which ``fn`` takes as its last argument; raise on a non-zero
    cudaError_t.  Where ``device`` is not the current device it is made
    current for this call only (the caller's restored after): entering
    that context costs host time a serving step would pay on every step."""
    import torch
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {err}")
