"""Quickstart: every major surface of mfcc_tpu_torch in one script.

Run: python -m mfcc_tpu_torch.examples.quickstart [path/to/16khz.wav]
     [--backend cpu]
"""

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("wav", nargs="?", default=None,
                    help="a 16 kHz wav (default: a synthetic 1 s chirp)")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="'cuda' (default) is the card; 'cpu' the host")
    args = ap.parse_args(argv)

    import torch
    from mfcc_tpu_torch import MFCC, MFCCConfig
    from mfcc_tpu_torch.io import wav
    from mfcc_tpu_torch.cli import backend_device
    from mfcc_tpu_torch.streaming import StreamingMFCC
    from mfcc_tpu_torch.utils.liftering import lifter
    from mfcc_tpu_torch.utils.vad import has_voice

    dev = backend_device(args.backend, "quickstart")
    if args.wav:
        audio, sr = wav.read(args.wav)
        print(f"loaded {args.wav}: {len(audio)} samples @ {sr} Hz")
    else:
        t = np.arange(16000) / 16000.0
        audio = (10000 * np.sin(2 * np.pi * (300 + 2000 * t) * t)
                 ).astype(np.int16)
        print("using a synthetic 1 s chirp (pass a wav path for real audio)")

    cfg = MFCCConfig()                        # 512/170, 32 mel, 32 cepstra
    fe = MFCC(cfg, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)

    # 1. batch float path -----------------------------------------------------
    cep = fe(x).cpu().numpy()
    print(f"float cepstra: {cep.shape}  c0 range "
          f"[{cep[:, 0].min():.1f}, {cep[:, 0].max():.1f}]")

    # 2. bit-exact fixed-point path (the FPGA RTL's arithmetic) ---------------
    icep = fe.int(x).cpu().numpy()
    print(f"int cepstra:   {icep.shape}  (bit-exact vs the reference RTL)")
    print(f"voice activity: {bool(has_voice(icep))}")

    # 3. streaming with checkpointable state + soft reset ---------------------
    sm = StreamingMFCC(cfg, device=dev)
    state = sm.init(n_streams=1)
    feats, mask, state = sm.step(x[None, :1024], state)
    print(f"streaming step: {int(mask.sum())} frames emitted, "
          f"carry count = {int(state.count[0])} samples")
    feats, dmask, state = sm.drain(state)     # flush the partial final frame
    print(f"drain: {int(dmask.sum())} residual frames flushed")

    # 4. liftered coefficients (software/lift.py role) ------------------------
    print(f"liftered c1 of frame 0: {float(lifter(cep)[0, 1]):.2f}")

    # 5. batch over many streams / many files ---------------------------------
    batch = torch.stack([x, x.flip(0)])
    print(f"batch of 2 streams -> {tuple(fe(batch).shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
