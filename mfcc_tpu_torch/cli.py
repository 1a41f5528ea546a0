"""Command-line surface: ``python -m mfcc_tpu_torch.cli <command>``.

The counterpart of ``mfcc_tpu.cli``: the same commands, arguments,
defaults, output files and lines.  Mirrors the reference's console scripts
and host tools (setup.py:25-31, software/):

  convert   batch wav dir -> .mfcc int16 files     (wav2mfcc + main.c:206-247)
  serve     long-lived TCP feature server          (the FPGA's device role)
  stream    sample-word stream -> framed features  (mic2mfcc + recv)
  mic       live microphone -> framed features     (mic2mfcc)
  recv      decode a framed feature stream          (recv.py/recv.c)
  goldens   librosa-recipe .spec/.sklearn goldens   (genlibrosa.py)
  lift      cepstral liftering of .mfcc files       (lift.py)
  view      5-panel comparison figure               (view.py)
  selftest  pipeline simulation vs the oracles      (mfcc-sim)
  probe     every pipeline stage's output -> .npz

Every command that computes (convert, stream, mic, selftest, serve, probe)
runs on the CUDA card unless given ``--backend cpu``; on a host without a
card it exits non-zero and names ``--backend cpu``, and never runs on the
CPU by itself.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

BACKENDS = ("cuda", "cpu")


def backend_device(backend: str, what: str):
    """The compute device of ``--backend``: ``"cuda"`` is the card (the
    current CUDA device), ``"cpu"`` the host.  Without a card, ``"cuda"``
    exits non-zero with ``pipeline.resolve_device``'s message and the flag
    that runs on the host; it never falls back to the CPU."""
    import torch
    from .pipeline import resolve_device
    if backend == "cpu":
        return torch.device("cpu")
    try:
        return resolve_device(None, what)
    except RuntimeError as e:
        raise SystemExit(f"mfcc_tpu_torch {what}: {e} (on the command "
                         "line: --backend cpu)")


def _device(args):
    return backend_device(args.backend, args.cmd)


def _fe(args):
    from .config import MFCCConfig
    from .pipeline import MFCC
    cfg = MFCCConfig(nceptrums=args.ncep)
    return MFCC(cfg, device=_device(args)), cfg


def _valid(feats, mask, as_float: bool) -> np.ndarray:
    """Stream 0's valid feature rows as int16 (float rounded, clipped)."""
    valid = feats[0][mask[0]].cpu().numpy()
    if as_float:
        valid = np.clip(np.round(valid), -32768, 32767)
    return valid.astype(np.int16)


def cmd_convert(args) -> int:
    """Recursive wav -> .mfcc conversion (int16), batched onto the card.

    Output format matches the reference host converter: per frame,
    ``nceptrums`` int16 values appended to <name>.mfcc (main.c:154-165).
    The INT path (default) writes the RTL's exact fixed-point cepstra;
    --float writes the float pipeline rounded to int16.
    """
    import torch
    from .io import wav as wavio
    fe, cfg = _fe(args)

    paths = wavio.walk_wavs(args.path) if os.path.isdir(args.path) else [args.path]
    if not paths:
        print(f"no wav files under {args.path}", file=sys.stderr)
        return 1

    for i in range(0, len(paths), args.batch):
        chunk = paths[i: i + args.batch]
        mat, lengths, rates = wavio.read_batch(chunk)
        for r in rates[rates > 0]:
            if r != cfg.samplerate:
                print(f"warning: sample rate {r} != {cfg.samplerate}",
                      file=sys.stderr)
        # int16 is the kernels' wire type: K1 and K2 read it as it is
        x = torch.from_numpy(np.ascontiguousarray(mat, np.int16)).to(
            fe.window.device)
        if args.float:
            feats = fe(x).cpu().numpy()
            feats = np.clip(np.round(feats), -32768, 32767).astype(np.int16)
        else:
            feats = fe.int(x).cpu().numpy().astype(np.int16)
        for j, p in enumerate(chunk):
            nf = cfg.n_frames(int(lengths[j]))
            out = os.path.splitext(p)[0] + ".mfcc"
            feats[j, :nf].tofile(out)
            print(f"{p} -> {out} ({nf} frames)")
    return 0


def _stream_chunks(sm, state, s_arr, C: int, reset_first: bool):
    """Feed one reset epoch chunk by chunk; yields (feats, mask, state) per
    chunk.  Full chunks pass ``lengths=None`` (one K4 launch on the card);
    only a partial last chunk passes its length (the flush step).  The
    reset goes in the epoch's first chunk."""
    pos, n = 0, len(s_arr)
    reset = reset_first
    while pos < n:
        take = min(C, n - pos)
        chunk = np.zeros((1, C), np.int16)
        chunk[0, :take] = s_arr[pos: pos + take]
        lengths = None if take == C else np.array([take], np.int32)
        feats, mask, state = sm.step(chunk, state, np.array([reset]),
                                     lengths=lengths)
        reset = False
        pos += take
        yield feats, mask, state


def cmd_stream(args) -> int:
    """Read 32-bit sample words (file or stdin), run the streaming pipeline,
    write magic-framed big-endian features (file or stdout).

    The host-side twin of the wav2mfcc target's soft-reset protocol
    (words with bit 31 set reset the stream) combined with the mic2mfcc
    target's framed output."""
    from .io import transport
    from .streaming import StreamingMFCC
    from .config import MFCCConfig

    cfg = MFCCConfig(nceptrums=args.ncep)
    sm = StreamingMFCC(cfg, int_path=not args.float, device=_device(args))
    data = (sys.stdin.buffer.read() if args.infile == "-"
            else open(args.infile, "rb").read())
    words = np.frombuffer(data, dtype="<u4")
    samples, resets, trailing = transport.decode_stream(words)

    state = sm.init(1)
    out = sys.stdout.buffer if args.outfile == "-" else open(args.outfile, "wb")
    # sample-exact reset semantics, the server's code path
    # (transport.split_resets): each reset epoch is fed separately, with the
    # epoch's final partial chunk flushed via an explicit length -- every
    # sample is consumed, nothing dropped at the tail
    for s_arr, reset_first in transport.split_resets(samples, resets,
                                                     trailing):
        for feats, mask, state in _stream_chunks(sm, state, s_arr,
                                                 args.chunk, reset_first):
            out.write(transport.encode_frames(
                _valid(feats, mask, args.float)))
    if args.outfile != "-":
        out.close()
    return 0


def cmd_mic(args) -> int:
    """Live microphone -> magic-framed features: the mic2mfcc target
    (targets/mic2mfcc.py:19-74) with the capture device as the AudioReceiver
    (io/audio.py).  Captures raw int16 PCM from a subprocess (arecord/
    ffmpeg/sox/parec, or --command for anything else), streams it through
    the pipeline chunk by chunk, and writes framed features until EOF,
    --seconds, or Ctrl-C.  Pipe into ``recv --live -`` for a live view."""
    from .io import transport, capture
    from .streaming import StreamingMFCC
    from .config import MFCCConfig

    cfg = MFCCConfig(nceptrums=args.ncep)
    sm = StreamingMFCC(cfg, int_path=not args.float, device=_device(args))
    state = sm.init(1)
    out = sys.stdout.buffer if args.outfile == "-" else open(args.outfile, "wb")
    C = args.chunk
    total = 0
    limit = int(args.seconds * cfg.samplerate) if args.seconds else None
    cmd = args.command.split() if args.command else None
    try:
        with capture.Capture(cfg.samplerate, device=args.device,
                             command=cmd) as cap:
            while limit is None or total < limit:
                want = C if limit is None else min(C, limit - total)
                samples = cap.read(want)
                if len(samples) == 0:
                    break
                total += len(samples)
                chunk = np.zeros((1, C), np.int16)
                chunk[0, : len(samples)] = samples
                # a full chunk is one K4 launch; a short read (EOF, the
                # --seconds limit) is flushed with its length
                lengths = (None if len(samples) == C
                           else np.array([len(samples)], np.int32))
                feats, mask, state = sm.step(chunk, state, lengths=lengths)
                out.write(transport.encode_frames(
                    _valid(feats, mask, args.float)))
                if args.outfile != "-":
                    out.flush()
    except KeyboardInterrupt:
        pass
    finally:
        if args.outfile != "-":
            out.close()
    print(f"captured {total} samples "
          f"({total / cfg.samplerate:.2f} s)", file=sys.stderr)
    return 0


def cmd_recv(args) -> int:
    """Decode a magic-framed feature byte stream (recv.py:12-42), with the
    host voice-activity check (cepstrum.c:161-183) via --vad.

    ``--live`` scrolls the stream as an inferno spectrogram while it runs --
    the recv.c SDL-viewer role (recv.c:20-76,101-155).  The input may be a
    file being appended, '-' (stdin pipe), or 'host:port' (a FeatureServer
    feature stream).  ``--window`` opens a matplotlib animation instead of
    the terminal renderer."""
    from .io import transport
    if args.live:
        from .utils import viewer
        read, close = viewer.open_source(args.infile)
        frames = viewer.follow_frames(read, args.ncep,
                                      idle_timeout=args.idle_timeout)
        try:
            if args.window:
                sc = viewer.MatplotlibScroller(args.ncep)
                sc.run(frames)
            else:
                sc = viewer.TerminalScroller(args.ncep, height=args.height)
                try:
                    for cols in frames:
                        sc.push(cols)
                except KeyboardInterrupt:
                    pass
                sc.close()
                print(f"{sc.n_frames} frames", file=sys.stderr)
        finally:
            close()
        return 0
    data = (sys.stdin.buffer.read() if args.infile == "-"
            else open(args.infile, "rb").read())
    cep, consumed = transport.decode_frames(data, args.ncep)
    print(f"decoded {cep.shape[0]} frames ({consumed} bytes)", file=sys.stderr)
    if args.vad and len(cep):
        from .utils.vad import voice_activity_power, DEFAULT_THRESHOLD
        p = int(voice_activity_power(cep))
        print(f"voice activity power={p} "
              f"{'VOICE' if p > DEFAULT_THRESHOLD else 'silence'}",
              file=sys.stderr)
    if args.outfile:
        cep.astype(np.int16).tofile(args.outfile)
    else:
        np.savetxt(sys.stdout, cep, fmt="%d")
    return 0


def cmd_goldens(args) -> int:
    """librosa-recipe goldens: <name>.spec (int16 mfcc) and <name>.sklearn
    (int16 per-row standardized), as genlibrosa.py:14-28."""
    from .io import wav as wavio
    from .compat import librosa_mfcc as lr

    paths = wavio.walk_wavs(args.path) if os.path.isdir(args.path) else [args.path]
    for p in paths:
        samples, sr = wavio.read(p)
        spec = lr.mfcc(samples, sr=sr, hop=170, n_mfcc=args.ncep)
        scale = lr.sklearn_scale(spec, axis=1)
        spec.astype(np.int16).tofile(os.path.splitext(p)[0] + ".spec")
        scale.astype(np.int16).tofile(os.path.splitext(p)[0] + ".sklearn")
        print(f"{p} -> .spec/.sklearn ({spec.shape[1]} frames)")
    return 0


def cmd_lift(args) -> int:
    """Cepstral liftering of .mfcc files -> .lift (lift.py:29-40)."""
    from .utils.liftering import lifter
    import glob
    pattern = (os.path.join(args.path, "**", "*.mfcc")
               if os.path.isdir(args.path) else args.path)
    for p in sorted(glob.glob(pattern, recursive=True)):
        arr = np.fromfile(p, dtype=np.int16).reshape(-1, args.ncep)
        out = os.path.splitext(p)[0] + ".lift"
        lifter(arr, args.L).astype(np.int16).tofile(out)
        print(f"{p} -> {out} ({arr.shape[0]} frames)")
    return 0


def cmd_view(args) -> int:
    """5-panel comparison figure: wav, .mfcc, .lift, .spec, .sklearn
    (view.py:18-53).  Saves <basename>_view.png (headless-friendly)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from .io import wav as wavio

    base = args.basename
    fig, axs = plt.subplots(5, figsize=(15, 8))
    samples, sr = wavio.read(base + ".wav")
    axs[0].plot(np.linspace(0, len(samples) / sr, num=len(samples)), samples)
    axs[0].grid(True)
    axs[0].set_ylabel("wav")

    panels = [(".mfcc", "mfcc", (-1, args.ncep), False),
              (".lift", "lift", (-1, args.ncep), False),
              (".spec", "librosa", (args.ncep, -1), True),
              (".sklearn", "sklearn", (args.ncep, -1), True)]
    for ax, (ext, label, shape, rowmajor) in zip(axs[1:], panels):
        try:
            raw = np.fromfile(base + ext, dtype=np.int16).reshape(shape)
            img = raw if rowmajor else raw.T
            ax.imshow(img, aspect="auto", origin="lower", cmap="inferno")
        except (FileNotFoundError, ValueError):
            ax.text(0.4, 0.5, f"({ext} missing)")
        ax.set_ylabel(label)
    out = base + "_view.png"
    fig.savefig(out, dpi=100)
    plt.close(fig)
    print(f"wrote {out}")
    return 0


def selftest_signal() -> np.ndarray:
    """The self-test's synthetic int16 signal: 11 frames of an 800 Hz tone
    plus uniform noise (``mfcc_tpu.cli``'s, same seed and formula)."""
    rng = np.random.default_rng(0)
    t = np.arange(512 + 10 * 170) / 16000
    return np.clip(8000 * np.sin(2 * np.pi * 800 * t)
                   + rng.integers(-2000, 2000, len(t)), -32768, 32767
                   ).astype(np.int16)


def cmd_selftest(args) -> int:
    """End-to-end pipeline check against the oracles (the mfcc-sim role,
    mfcc/core/mfcc.py:120-204), asserted instead of visual.  On the card
    it also holds ``MFCC()`` (K1) and ``MFCC().int`` (K2) against their
    plain versions on the CPU."""
    import torch
    from .config import MFCCConfig
    from .pipeline import MFCC
    from .ref import int_ref, float_ref

    cfg = MFCCConfig()
    sig = selftest_signal()
    dev = _device(args)
    fe = MFCC(cfg, device=dev)
    x = torch.from_numpy(sig).to(dev)
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        print(f"{name}: {'PASS' if cond else 'FAIL'} {detail}")
        ok &= bool(cond)

    want_int = int_ref.mfcc_int(sig.astype(np.int64), cfg)
    got_int = fe.int(x).cpu().numpy()
    check("INT path bit-exact vs RTL oracle",
          np.array_equal(want_int, got_int))

    want_f = float_ref.mfcc_float(sig, cfg)
    got_f = fe(x.to(torch.float32)).cpu().numpy()
    err = float(np.abs(want_f - got_f).max())
    check("float path vs float64 oracle", err < 5e-4,
          f"(max|err|={err:.2e})")

    # streaming == batch for an adversarial chunking (INT: exact)
    from .streaming import StreamingMFCC
    sm = StreamingMFCC(cfg, int_path=True, device=dev)
    C = 173
    n = (len(sig) // C) * C
    outs, _ = sm.process(sig[None, :n], chunk_size=C)
    nf = outs[0].shape[0]
    check("streaming == batch (chunk 173, INT exact)",
          nf > 0 and np.array_equal(outs[0], want_int[:nf]))

    # wire protocol roundtrip (sample words in, framed columns out)
    from .io import transport
    words = transport.encode_stream(sig[:64].astype(np.int16),
                                    reset_first=True)
    samples, resets, _ = transport.decode_stream(words)
    enc = transport.encode_frames(want_int[:3].astype(np.int16))
    dec, _ = transport.decode_frames(b"\x00" + enc, cfg.nceptrums)
    check("wire protocols roundtrip",
          np.array_equal(samples, sig[:64]) and bool(resets[0])
          and np.array_equal(dec, want_int[:3].astype(np.int16)))

    # the kernels (card only) against their plain versions on the CPU
    if dev.type == "cuda":
        plain = MFCC(cfg, device="cpu")
        xc = torch.from_numpy(sig)
        kerr = float(np.abs(got_f - plain(xc.to(torch.float32)).numpy()
                            ).max())
        check("fused float kernel (K1) vs its plain version", kerr < 5e-5,
              f"(max|err|={kerr:.2e})")
        check("fused INT kernel (K2) bit-exact vs its plain version",
              np.array_equal(got_int, plain.int(xc).numpy()))

    print("SELFTEST", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def cmd_serve(args) -> int:
    """Run the FeatureServer as a long-lived TCP service -- the reference's
    device role (the FPGA behind the FT601 link, wav2mfcc.py:15-47) as a
    deployable process.  Clients speak the same wire protocol as the
    reference host tools: uint32 sample words in (bit 31 = soft reset),
    magic-framed big-endian int16 feature columns out."""
    import time as _time
    from .config import MFCCConfig
    from .server import FeatureServer

    cfg = MFCCConfig(nceptrums=args.ncep)
    srv = FeatureServer(cfg, host=args.host, port=args.port,
                        max_streams=args.streams, chunk=args.chunk,
                        int_path=not args.float,
                        device=_device(args),
                        transposed_chunks=args.transposed_chunks,
                        pipeline_depth=args.pipeline_depth,
                        status_port=args.status_port)
    path = "float" if args.float else "bit-exact INT"
    print(f"warming up ({path} path, {args.streams} slots, "
          f"chunk={args.chunk} samples = "
          f"{1e3 * args.chunk / cfg.samplerate:.0f} ms)...", flush=True)
    srv.start()
    host, port = srv.address
    print(f"serving on {host}:{port}", flush=True)
    if srv.status_address is not None:
        print(f"status plane on {srv.status_address[0]}:"
              f"{srv.status_address[1]}", flush=True)
    t0 = _time.time()
    try:
        while args.duration is None or _time.time() - t0 < args.duration:
            _time.sleep(min(args.stats_every,
                            1.0 if args.duration else args.stats_every))
            st = srv.stats()
            if args.duration is None or st["steps"]:
                act = srv.activity()
                busy = sum(1 for rx, _ in act if rx)
                print(f"slots_seen={busy}/{args.streams} "
                      f"steps={st['steps']} frames_tx={st['frames_tx']} "
                      f"gather={st['gather_s']:.1f}s "
                      f"compute={st['compute_s']:.1f}s "
                      f"deliver={st['deliver_s']:.1f}s", flush=True)
    except KeyboardInterrupt:
        print("stopping", flush=True)
    srv.stop()
    return 0


def cmd_probe(args) -> int:
    """Dump every pipeline stage's output for a wav -- the LiteScope /
    gen_collector observability role (debug/scope.py, mfcc.py:128-141) as
    an .npz + optional png."""
    import torch
    from .io import wav as wavio
    from .utils import debug

    dev = _device(args)
    sig, sr = wavio.read(args.wav)
    if args.frames:
        sig = sig[: 512 + (args.frames - 1) * 170]
    fn = debug.int_intermediates if args.int else debug.float_intermediates
    x = sig.astype(np.int64) if args.int else sig.astype(np.float32)
    inter = fn(torch.from_numpy(x).to(dev))
    out = {k: v.cpu().numpy() for k, v in inter.items()}
    dest = os.path.splitext(args.wav)[0] + ("_int" if args.int else "_float") \
        + "_stages.npz"
    np.savez(dest, **out)
    for k, v in out.items():
        print(f"{k:12s} {v.shape} {v.dtype}")
    print(f"wrote {dest}")
    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        keys = [k for k in ("frames", "window", "power", "filterbank",
                            "log", "dct", "cepstra") if k in out]
        fig, axs = plt.subplots(len(keys), figsize=(12, 2 * len(keys)))
        for ax, k in zip(axs, keys):
            v = out[k]
            img = np.abs(v.reshape(v.shape[-2], v.shape[-1])) if v.ndim == 2 \
                else np.abs(v[0])
            ax.imshow(np.asarray(img, float).T, aspect="auto",
                      origin="lower", cmap="inferno")
            ax.set_ylabel(k)
        png = dest.replace(".npz", ".png")
        fig.savefig(png, dpi=100)
        plt.close(fig)
        print(f"wrote {png}")
    return 0


def _backend(p) -> None:
    p.add_argument("--backend", choices=BACKENDS, default="cuda",
                   help="where it computes: 'cuda' (default) is the card "
                        "and fails on a host without one; 'cpu' runs the "
                        "plain torch versions on the host")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mfcc_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("convert", help="wav dir -> .mfcc files")
    p.add_argument("path")
    p.add_argument("--float", action="store_true",
                   help="float pipeline instead of bit-exact INT")
    p.add_argument("--ncep", type=int, default=32)
    p.add_argument("--batch", type=int, default=64)
    _backend(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("stream", help="sample words -> framed features")
    p.add_argument("infile", help="'-' for stdin (little-endian uint32 words)")
    p.add_argument("outfile", nargs="?", default="-")
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--ncep", type=int, default=16)
    p.add_argument("--float", action="store_true")
    _backend(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("mic", help="live microphone -> framed features")
    p.add_argument("outfile", nargs="?", default="-")
    p.add_argument("--device", default=None,
                   help="capture device name (tool-specific)")
    p.add_argument("--command", default=None,
                   help="explicit capture command writing raw mono int16 "
                        "PCM to stdout (overrides tool detection)")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="stop after N seconds (0 = until EOF/Ctrl-C)")
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--ncep", type=int, default=16)
    p.add_argument("--float", action="store_true")
    _backend(p)
    p.set_defaults(fn=cmd_mic)

    p = sub.add_parser("recv", help="decode framed feature stream")
    p.add_argument("infile", help="file | '-' (stdin) | host:port (--live)")
    p.add_argument("outfile", nargs="?")
    p.add_argument("--ncep", type=int, default=16)
    p.add_argument("--vad", action="store_true",
                   help="report voice activity (cepstrum.c threshold)")
    p.add_argument("--live", action="store_true",
                   help="scrolling spectrogram while the stream runs (recv.c)")
    p.add_argument("--window", action="store_true",
                   help="with --live: matplotlib window instead of terminal")
    p.add_argument("--height", type=int, default=24,
                   help="terminal rows for --live (2 frames per row)")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="stop --live after N seconds without data")
    p.set_defaults(fn=cmd_recv)

    p = sub.add_parser("goldens", help="librosa-recipe .spec/.sklearn goldens")
    p.add_argument("path")
    p.add_argument("--ncep", type=int, default=32)
    p.set_defaults(fn=cmd_goldens)

    p = sub.add_parser("lift", help="cepstral liftering of .mfcc files")
    p.add_argument("path")
    p.add_argument("--ncep", type=int, default=32)
    p.add_argument("-L", type=int, default=22)
    p.set_defaults(fn=cmd_lift)

    p = sub.add_parser("view", help="comparison panels -> png")
    p.add_argument("basename")
    p.add_argument("--ncep", type=int, default=32)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("selftest", help="pipeline vs oracles")
    _backend(p)
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("serve", help="run the TCP FeatureServer")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5533)
    p.add_argument("--streams", type=int, default=64,
                   help="max concurrent client slots (one batched step)")
    p.add_argument("--chunk", type=int, default=1024,
                   help="samples per batched step; smaller = lower latency,"
                        " larger = more capacity")
    p.add_argument("--ncep", type=int, default=32)
    p.add_argument("--float", action="store_true",
                   help="float path (serving default is bit-exact INT); "
                        "silence clamps like the RTL (mel_floor=1)")
    _backend(p)
    p.add_argument("--transposed-chunks", action="store_true",
                   help="gather chunks positions-major (the kernel reads "
                        "them in place)")
    p.add_argument("--pipeline-depth", type=int, default=2)
    p.add_argument("--status-port", type=int, default=None,
                   help="also serve the control/status line protocol "
                        "(PING/STATS/SLOTS/CONFIG/LOGLEVEL) on this port "
                        "(0 = ephemeral) -- the Wishbone-bridge register "
                        "plane role.  It binds --host and takes LOGLEVEL "
                        "writes from any peer that reaches it: for trusted "
                        "networks only")
    p.add_argument("--stats-every", type=float, default=10.0)
    p.add_argument("--duration", type=float, default=None,
                   help="exit after N seconds (default: run until SIGINT)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("probe", help="dump all pipeline stages (.npz)")
    p.add_argument("wav")
    p.add_argument("--int", action="store_true")
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--png", action="store_true")
    _backend(p)
    p.set_defaults(fn=cmd_probe)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
