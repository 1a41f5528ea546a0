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
    FP64: K7 and K7-frames (``ops/f64ish.py``, ``csrc/fladder.cu``) behind
    ``MFCC``, ``float_ops`` and ``StreamingMFCC``; and the ``"split"``
    precision and ``method="segmented"`` of the ``float_ops`` chain;
  * the entries that no route of ``MFCC`` reaches, the counterparts of the
    JAX package's bench candidates: K8, one FP64 dense-DFT kernel
    (``csrc/dense_dft.cu``) behind the seven entries of
    ``ops/dense_fused.py``; K9 (``int_fused.mfcc_int_v2``) on K2's
    kernel, K3-v1 (``mfcc_int_v1``) on K2's behind an int32 ingest, and K10
    (``mfcc_int_split2``), K2's function in two launches
    (``csrc/int_split2.cu``);
  * multi-rank sharding on ``torch.distributed`` (``parallel/``): dp over
    streams and sp over time with an explicit halo exchange, each rank
    running the kernels above on its block (sharded float through K1,
    or K6 at an odd hop, INT through K2, the INT halo through K3,
    streaming through K4); ``parallel.bootstrap.run_in_group`` starts the
    ranks (on the card unless ``device_type="cpu"``; gloo on the CPU and
    for ranks that share a card, NCCL one rank a card);
  * a second recipe of the float front-end, Kaldi's MFCC (``KaldiConfig``;
    ``KALDI_MFCC_HIRES`` is ``conf/mfcc_hires.conf``): ``MFCC`` on K1's
    Kaldi instantiation (``fladder.mfcc_kaldi_ladder``), ``StreamingMFCC``
    on the chain with that kernel as its features, against the plain
    reference ``ref/kaldi_ref.py``;
  * a log-mel recipe, Whisper's front-end (``WhisperConfig``;
    ``WHISPER_V3_LOG_MEL`` is large-v3's 128 bins): ``MFCC`` on K11 and
    K11-norm (``ops/whisper.py``, ``csrc/whisper_mel.cu``), (..., T) ->
    (..., nfilters, T // hop), against the plain reference
    ``ref/whisper_ref.py``; whole windows only (no streaming);
  * SeamlessM4T's fbank, the extractor of w2v-BERT 2.0 and SeamlessM4T v2
    (``SeamlessFbankConfig``; ``W2V_BERT_2_FBANK`` is its 80 bins):
    ``MFCC(cfg)(audio, lengths)`` on ragged batches, K12 and K12-cmvn
    (``ops/seamless.py``, ``csrc/seamless_fbank.cu``), -> (features (B,
    F_pad / 2, 160), attention mask), against the plain reference
    ``ref/seamless_ref.py``; whole utterances only (no streaming);
  * the model family (``models/``: ``nn.Module`` feature extractors,
    differentiable through the float chain), the debug taps
    (``utils/debug.py``, ``MFCC.intermediates``), ``utils/vad.py``,
    ``utils/liftering.py`` and ``compat/librosa_mfcc.py``.

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

from .config import (MFCCConfig, DEFAULT_CONFIG, MIC_CONFIG, KaldiConfig,
                     KALDI_MFCC_HIRES, WhisperConfig, WHISPER_V3_LOG_MEL,
                     SeamlessFbankConfig, W2V_BERT_2_FBANK)
from .pipeline import MFCC
from .streaming import StreamingMFCC, StreamState
from .server import FeatureServer

__version__ = "0.1.0"

__all__ = ["MFCC", "MFCCConfig", "DEFAULT_CONFIG", "MIC_CONFIG",
           "KaldiConfig", "KALDI_MFCC_HIRES", "WhisperConfig",
           "WHISPER_V3_LOG_MEL", "SeamlessFbankConfig", "W2V_BERT_2_FBANK",
           "StreamingMFCC", "StreamState",
           "FeatureServer", "__version__"]
