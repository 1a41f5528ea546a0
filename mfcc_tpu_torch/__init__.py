"""mfcc_tpu_torch -- the MFCC front-end on PyTorch and CUDA (NVIDIA Hopper).

A port of ``mfcc_tpu`` (JAX/Pallas on a TPU), which stays the reference.
The same ``MFCCConfig``, the same layouts and the same numeric contracts:
float cepstra within 5e-4 of the float64 oracle ``ref.float_ref``, INT
cepstra element-exact with the RTL oracle ``ref.int_ref``.

Ported so far:

  * the float batch path ``MFCC()(audio)`` and ``MFCC.frames``; its fused
    kernel (K1, ``ops/fladder.py``) is CUDA C++ for sm_90a in
    ``csrc/fladder.cu``;
  * the bit-exact INT batch path ``MFCC.int`` and ``MFCC.int_frames``
    (``ops/int_ops.py`` chain); its fused kernels (K2 from audio, K3 from
    frames, ``ops/int_fused.py``) are CUDA C++ for sm_90a in
    ``csrc/int_mfcc.cu`` on the device functions of
    ``csrc/int_stages.cuh``;
  * the serving path: ``StreamingMFCC`` (float and bit-exact INT, chunked
    output equal to batch output for any chunking) and ``FeatureServer``
    (the TCP server of the reference's wire formats) on top of it; its
    fused step kernels (K4 float and INT, ``ops/stream_fused.py``) are
    CUDA C++ for sm_90a in ``csrc/stream_step.cu``, on the tails of K1
    (``csrc/fladder_stages.cuh``) and K2 (``csrc/int_stages.cuh``);
  * the ``precision="fast"`` dial and odd hops: K5 and K5-frames
    (``ops/float_fused.py``, ``csrc/float_fused.cu``), the split-DFT
    serving step, and K6 on K1's kernel;
  * the ``precision="f64ish"`` dial (the max(1e-5, 2 ulp) contract) in
    FP64: K7 and K7-frames (``ops/f64ish.py``, ``csrc/f64ish.cu``) behind
    ``MFCC``, ``float_ops`` and ``StreamingMFCC``; and the ``"split"``
    precision and ``method="segmented"`` of the ``float_ops`` chain;
  * the entries that no route of ``MFCC`` reaches, the counterparts of the
    JAX package's bench candidates: K8, one FP64 dense-DFT kernel
    (``csrc/dense_dft.cu``) behind the seven entries of
    ``ops/dense_fused.py``; K9 (``int_fused.mfcc_int_v2``) on K2's
    kernel, K3-v1 (``mfcc_int_v1``) on K3's, and K10
    (``mfcc_int_split2``), K2's function in two launches
    (``csrc/int_split2.cu``).

``MFCC()``, ``StreamingMFCC()`` and ``FeatureServer()`` run on the CUDA
card by default; ``device="cpu"`` runs the plain torch versions on the
host.

Kernel build route: at first use, ``kernels/build.py`` runs ``nvcc
-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler
-fPIC`` on each ``csrc/*.cu``, one library per source built in parallel,
into ``mfcc_tpu_torch/_build/`` (rebuilt when a source's hash changes)
and binds the plain C entry points with ``ctypes``.
Importing the package builds nothing and never imports JAX.
"""

from .config import MFCCConfig, DEFAULT_CONFIG, MIC_CONFIG
from .pipeline import MFCC
from .streaming import StreamingMFCC, StreamState
from .server import FeatureServer

__version__ = "0.1.0"

__all__ = ["MFCC", "MFCCConfig", "DEFAULT_CONFIG", "MIC_CONFIG",
           "StreamingMFCC", "StreamState", "FeatureServer", "__version__"]
