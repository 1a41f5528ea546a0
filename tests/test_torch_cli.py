"""The port's command line (``mfcc_tpu_torch.cli``, ``_entry``) against the
JAX package's (``mfcc_tpu.cli``) on the CPU, on the same inputs.

Both run in this process: the JAX CLI under ``JAX_PLATFORMS=cpu`` (with
``--backend cpu`` where it has the flag), the port with ``--backend cpu``.
Inputs are small: ``audio_int16`` (1,192 samples) or synthetic wavs of at
most 1 s.  Tolerances: INT outputs (``.mfcc``, the stream bytes) and the
numpy-only commands (``recv``, ``goldens``, ``lift``) byte for byte; float
outputs rounded to int16 within 1 (the frameworks' f32 sums differ in
order, which can move a value across a rounding boundary); the float probe
taps as ``tests/test_torch_utils.py`` holds them (the linear stages within
1e-6 of their largest value, log, DCT and cepstra within 1e-4).
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mfcc_tpu import _entry as jentry, cli as jcli

from mfcc_tpu_torch import _entry, cli
from mfcc_tpu_torch.config import MFCCConfig
from mfcc_tpu_torch.io import transport
from mfcc_tpu_torch.ref import int_ref
from mfcc_tpu_torch.server import stream_samples
from mfcc_tpu_torch.streaming import StreamingMFCC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--backend", "cpu"]
REL = 1e-6
TOL_JAX = 1e-4
LINEAR = ("emph", "frames", "window", "fft_re", "fft_im", "power",
          "filterbank")


def _signal(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = (7000 * np.sin(2 * np.pi * (250 + 900 * seed) * t)
         + rng.integers(-2500, 2500, n))
    return np.clip(x, -32768, 32767).astype(np.int16)


def _wav_dirs(tmp_path, lengths):
    """Two identical trees of synthetic 16 kHz wavs (one for each CLI, whose
    outputs land beside the inputs), a subdirectory included."""
    a, b = tmp_path / "jax", tmp_path / "port"
    (a / "sub").mkdir(parents=True)
    for i, n in enumerate(lengths):
        name = f"sub/w{i}.wav" if i % 2 else f"w{i}.wav"
        wavfile.write(str(a / name), 16000, _signal(n, i + 1))
    shutil.copytree(a, b)
    return a, b


def _outputs(root, ext):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(ext))


@pytest.mark.parametrize("as_float", [False, True], ids=["int", "float"])
def test_convert_matches_jax(tmp_path, capsys, as_float):
    a, b = _wav_dirs(tmp_path, [5000, 16000, 7777])
    flag = ["--float"] if as_float else []
    assert jcli.main(["convert", str(a), "--batch", "2", *flag]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["convert", str(b), "--batch", "2", *flag, *CPU]) == 0
    out = capsys.readouterr().out
    assert out.replace(str(b), "") == jout.replace(str(a), "")
    names = _outputs(a, ".mfcc")
    assert len(names) == 3 and names == _outputs(b, ".mfcc")
    for name in names:
        want = np.fromfile(a / name, np.int16)
        got = np.fromfile(b / name, np.int16)
        assert got.shape == want.shape and len(got) % 32 == 0, name
        if as_float:
            assert np.abs(got.astype(int) - want).max() <= 1, name
        else:
            assert (b / name).read_bytes() == (a / name).read_bytes(), name
            rate, sig = wavfile.read(str(b / name).replace(".mfcc", ".wav"))
            assert np.array_equal(got.reshape(-1, 32), int_ref.mfcc_int(
                sig.astype(np.int64)).astype(np.int16))


def test_convert_empty_dir(tmp_path, capsys):
    assert cli.main(["convert", str(tmp_path), *CPU]) == 1
    assert "no wav files under" in capsys.readouterr().err


def _stream_words(sig):
    """Sample words with soft resets before samples 1100 and 2501 (not
    chunk-aligned) and a partial final chunk (3,200 samples at C=1024)."""
    return np.concatenate([
        transport.encode_stream(sig[:1100]),
        transport.encode_stream(sig[1100:2501], reset_first=True),
        transport.encode_stream(sig[2501:], reset_first=True)])


@pytest.mark.parametrize("as_float", [False, True], ids=["int", "float"])
def test_stream_matches_jax(tmp_path, as_float):
    sig = _signal(3200, 7)
    src = tmp_path / "words.bin"
    src.write_bytes(_stream_words(sig).astype("<u4").tobytes())
    flag = ["--float"] if as_float else []
    jdst, dst = tmp_path / "jax.bin", tmp_path / "port.bin"
    assert jcli.main(["stream", str(src), str(jdst), *flag,
                      "--backend", "cpu"]) == 0
    assert cli.main(["stream", str(src), str(dst), *flag, *CPU]) == 0
    want, _ = transport.decode_frames(jdst.read_bytes(), 16)
    got, _ = transport.decode_frames(dst.read_bytes(), 16)
    assert got.shape == want.shape
    if as_float:
        assert np.abs(got.astype(int) - want).max() <= 1
        return
    assert dst.read_bytes() == jdst.read_bytes()
    cfg = MFCCConfig(nceptrums=16)
    epochs = [sig[:1100], sig[1100:2501], sig[2501:]]
    oracle = np.concatenate([int_ref.mfcc_int(e.astype(np.int64), cfg)
                             for e in epochs])
    assert np.array_equal(got, oracle.astype(np.int16))


def test_stream_passes_lengths_on_partial_chunks_only(tmp_path, monkeypatch):
    """Full chunks take the fused step (one K4 launch on the card), only the
    last, partial chunk of each reset epoch the flush step; the reset rides
    in each epoch's first chunk."""
    calls = []
    fused, chain = StreamingMFCC._fused_step, StreamingMFCC._chain_step

    def spy_fused(self, chunks, state, reset):
        calls.append(("full", bool(reset.any())))
        return fused(self, chunks, state, reset)

    def spy_chain(self, chunks, state, reset, lengths):
        calls.append((int(lengths[0]), bool(reset.any())))
        return chain(self, chunks, state, reset, lengths)

    monkeypatch.setattr(StreamingMFCC, "_fused_step", spy_fused)
    monkeypatch.setattr(StreamingMFCC, "_chain_step", spy_chain)
    src = tmp_path / "words.bin"
    src.write_bytes(_stream_words(_signal(3200, 7)).astype("<u4").tobytes())
    assert cli.main(["stream", str(src), str(tmp_path / "o.bin"), *CPU]) == 0
    # epochs of 1100, 1401 and 699 samples at C=1024
    assert calls == [("full", False), (76, False), ("full", True),
                     (377, False), (699, True)]


def test_recv_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    cep = rng.integers(-3000, 3000, (30, 16)).astype(np.int16)
    cep[:, 0] = 15000                        # voice: c0^2 summed > 1e8
    data = b"\x17" + transport.encode_frames(cep) + b"\x5a"
    src = tmp_path / "feats.bin"
    src.write_bytes(data)
    for extra in ([], ["--vad"]):
        assert jcli.main(["recv", str(src), *extra]) == 0
        want = capsys.readouterr()
        assert cli.main(["recv", str(src), *extra]) == 0
        got = capsys.readouterr()
        assert got.out == want.out and got.err == want.err
    assert "VOICE" in got.err
    jdst, dst = tmp_path / "j.bin", tmp_path / "p.bin"
    assert jcli.main(["recv", str(src), str(jdst)]) == 0
    assert cli.main(["recv", str(src), str(dst)]) == 0
    assert dst.read_bytes() == jdst.read_bytes()
    assert np.array_equal(np.fromfile(dst, np.int16).reshape(-1, 16), cep)


def test_goldens_and_lift_match_jax(tmp_path, capsys):
    a, b = _wav_dirs(tmp_path, [16000, 9000])
    assert jcli.main(["goldens", str(a)]) == 0
    assert cli.main(["goldens", str(b)]) == 0
    for ext in (".spec", ".sklearn"):
        names = _outputs(a, ext)
        assert len(names) == 2 and names == _outputs(b, ext)
        for name in names:
            assert (b / name).read_bytes() == (a / name).read_bytes(), name
    for root in (a, b):
        rng = np.random.default_rng(9)
        for name in ("w0.mfcc", "sub/w1.mfcc"):
            rng.integers(-9000, 9000, (12, 32)).astype(np.int16).tofile(
                root / name)
    capsys.readouterr()
    assert jcli.main(["lift", str(a)]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["lift", str(b)]) == 0
    assert capsys.readouterr().out.replace(str(b), "") == \
        jout.replace(str(a), "")
    for name in ("w0.lift", "sub/w1.lift"):
        assert (b / name).read_bytes() == (a / name).read_bytes(), name
    # the view of one basename, every panel present
    assert cli.main(["view", str(b / "w0")]) == 0
    png = b / "w0_view.png"
    assert png.exists() and png.read_bytes()[:4] == b"\x89PNG"


@pytest.mark.parametrize("as_int", [False, True], ids=["float", "int"])
def test_probe_matches_jax(tmp_path, audio_int16, as_int):
    a, b = tmp_path / "j.wav", tmp_path / "p.wav"
    for p in (a, b):
        wavfile.write(str(p), 16000, audio_int16)
    flag = ["--int"] if as_int else []
    assert jcli.main(["probe", str(a), *flag]) == 0
    assert cli.main(["probe", str(b), *flag, *CPU]) == 0
    suffix = "_int_stages.npz" if as_int else "_float_stages.npz"
    with np.load(str(a)[:-4] + suffix) as jz, \
            np.load(str(b)[:-4] + suffix) as tz:
        assert list(tz.keys()) == list(jz.keys())
        for k in jz.keys():
            w, g = jz[k], tz[k]
            assert g.shape == w.shape, k
            if as_int:
                assert np.array_equal(g, w), k
            else:
                bound = REL * np.abs(w).max() if k in LINEAR else TOL_JAX
                assert np.abs(g - w).max() <= bound, k


def test_probe_png(tmp_path, audio_int16, capsys):
    p = tmp_path / "s.wav"
    wavfile.write(str(p), 16000, audio_int16)
    assert cli.main(["probe", str(p), "--frames", "3", "--png", *CPU]) == 0
    out = capsys.readouterr().out
    assert "cepstra      (3, 32) float32" in out
    assert (tmp_path / "s_float_stages.png").exists()


def test_selftest_passes_on_the_cpu(capsys):
    assert cli.main(["selftest", *CPU]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "SELFTEST PASS"
    assert "FAIL" not in out and "kernel" not in out   # card checks only


def test_selftest_signal_is_jax_s():
    rng = np.random.default_rng(0)
    t = np.arange(512 + 10 * 170) / 16000
    want = np.clip(8000 * np.sin(2 * np.pi * 800 * t)
                   + rng.integers(-2000, 2000, len(t)), -32768, 32767
                   ).astype(np.int16)
    assert np.array_equal(cli.selftest_signal(), want)


def _fake_device(tmp_path, samples):
    """A 'microphone': a script that writes raw int16 PCM to stdout."""
    pcm = tmp_path / "mic.pcm"
    pcm.write_bytes(np.asarray(samples, "<i2").tobytes())
    script = tmp_path / "fakemic.sh"
    script.write_text(f"#!/bin/sh\ncat {pcm}\n")
    script.chmod(0o755)
    return str(script)


@pytest.mark.parametrize("as_float", [False, True], ids=["int", "float"])
def test_mic_end_to_end(tmp_path, audio_int16, capsys, as_float):
    """``mic`` with a fake device (in process): the exact batch features,
    the flushed partial final chunk included; float within 1 of the same
    stream through ``stream``."""
    script = _fake_device(tmp_path, audio_int16)          # 1192 samples
    out = tmp_path / "mic.bin"
    flag = ["--float"] if as_float else []
    assert cli.main(["mic", str(out), "--command", script, "--chunk",
                     "1024", *flag, *CPU]) == 0
    assert "captured 1192 samples" in capsys.readouterr().err
    cols, _ = transport.decode_frames(out.read_bytes(), 16)
    want = int_ref.mfcc_int(audio_int16.astype(np.int64),
                            MFCCConfig(nceptrums=16)).astype(np.int16)
    if not as_float:
        assert np.array_equal(cols, want)
        return
    words = tmp_path / "w.bin"
    words.write_bytes(transport.encode_stream(audio_int16).astype(
        "<u4").tobytes())
    assert jcli.main(["stream", str(words), str(tmp_path / "j.bin"),
                      "--float"]) == 0
    jcols, _ = transport.decode_frames((tmp_path / "j.bin").read_bytes(), 16)
    assert cols.shape == jcols.shape == want.shape
    assert np.abs(cols.astype(int) - jcols).max() <= 1


def test_mic_seconds_limit(tmp_path, audio_int16, capsys):
    script = _fake_device(tmp_path, audio_int16)
    out = tmp_path / "mic.bin"
    assert cli.main(["mic", str(out), "--command", script, "--seconds",
                     "0.05", *CPU]) == 0
    assert "captured 800 samples (0.05 s)" in capsys.readouterr().err
    cols, _ = transport.decode_frames(out.read_bytes(), 16)
    want = int_ref.mfcc_int(audio_int16[:800].astype(np.int64),
                            MFCCConfig(nceptrums=16)).astype(np.int16)
    assert np.array_equal(cols, want)


def test_serve_end_to_end(audio_int16):
    """``serve`` on the CPU for a bounded duration in a thread; one client
    gets the exact INT features (the twin of the JAX package's
    ``test_cli_serve_end_to_end``)."""
    buf = io.StringIO()
    rc = {}

    def run():
        with contextlib.redirect_stdout(buf):
            rc["rc"] = cli.main(["serve", "--port", "0", "--streams", "2",
                                 "--chunk", "512", "--duration", "12",
                                 "--stats-every", "2", *CPU])

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.time() + 60
    port = None
    while time.time() < deadline and port is None:
        m = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("serving on ")]
        if m:
            port = int(m[0].rsplit(":", 1)[1])
        else:
            time.sleep(0.1)
    assert port is not None, buf.getvalue()
    want = int_ref.mfcc_int(audio_int16.astype(np.int64)).astype(np.int16)
    cols = stream_samples("127.0.0.1", port, audio_int16, 32,
                          expect_frames=want.shape[0], timeout=30.0)
    assert np.array_equal(cols, want)
    th.join(timeout=60)
    assert not th.is_alive() and rc["rc"] == 0
    text = buf.getvalue()
    assert text.startswith("warming up (bit-exact INT path, 2 slots, "
                           "chunk=512 samples = 32 ms)...")
    assert "slots_seen=1/2 steps=" in text


def test_serve_help_names_the_status_plane_trust():
    parser_help = io.StringIO()
    with contextlib.redirect_stdout(parser_help), \
            pytest.raises(SystemExit):
        cli.main(["serve", "--help"])
    text = " ".join(parser_help.getvalue().split())
    assert "binds --host" in text and "trusted networks only" in text
    assert "--host HOST" in text


NO_BACKEND = {
    "convert": ["convert", "nowhere"],
    "stream": ["stream", "nowhere.bin"],
    "mic": ["mic", "--command", "true"],
    "selftest": ["selftest"],
    "serve": ["serve", "--port", "0", "--duration", "1"],
    "probe": ["probe", "nowhere.wav"],
}


@pytest.mark.parametrize("cmd", sorted(NO_BACKEND))
def test_computing_command_needs_the_card_or_backend_cpu(cmd):
    """Every command that computes runs on the card by default: here (no
    card) it exits non-zero naming ``--backend cpu``, and never runs on the
    CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(SystemExit) as e:
        cli.main(NO_BACKEND[cmd])
    assert e.value.code not in (0, None)
    assert "--backend cpu" in str(e.value.code)
    assert str(e.value.code).startswith(f"mfcc_tpu_torch {cmd}: ")


def test_module_entry_point_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-m", "mfcc_tpu_torch.cli",
                          "selftest"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "--backend cpu" in res.stderr
    assert "SELFTEST" not in res.stdout


@pytest.mark.parametrize("name", ["wav2mfcc", "mic2mfcc", "mfcc_sim"])
def test_entry_shims_forward_argv(name, monkeypatch):
    """The console-script shims call ``cli.main`` with the JAX shims'
    argument lists; ``mfcc_sim`` also forwards its arguments (so that
    ``mfcc-sim-torch --backend cpu`` runs on a host without a card)."""
    seen = {}

    def fake(tag):
        def main(argv=None):
            seen[tag] = list(argv)
            return 0
        return main

    monkeypatch.setattr(cli, "main", fake("port"))
    monkeypatch.setattr(jcli, "main", fake("jax"))
    monkeypatch.setattr(sys, "argv", [name, "in.bin", "out.bin"]
                        if name != "mfcc_sim" else [name])
    for mod in (jentry, _entry):
        with pytest.raises(SystemExit) as e:
            getattr(mod, name)()
        assert e.value.code == 0
    assert seen["port"] == seen["jax"]
    if name == "mfcc_sim":
        monkeypatch.setattr(sys, "argv", [name, "--backend", "cpu"])
        with pytest.raises(SystemExit):
            _entry.mfcc_sim()
        assert seen["port"] == ["selftest", "--backend", "cpu"]


def test_entry_selftest_runs(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["mfcc-sim-torch", "--backend", "cpu"])
    with pytest.raises(SystemExit) as e:
        _entry.mfcc_sim()
    assert e.value.code == 0
    assert "SELFTEST PASS" in capsys.readouterr().out
