"""The port's host I/O (``mfcc_tpu_torch.io``: ``wav``, ``capture``)
against the JAX package's on the same files.  Everything here is numpy
(the native loader where it is built, scipy otherwise): outputs are held
equal, element for element and dtype for dtype."""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from mfcc_tpu.io import capture as jcapture, wav as jwav

import mfcc_tpu_torch.io
from mfcc_tpu_torch.io import capture, native, wav


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, n).astype(np.int16)


@pytest.fixture
def wav_tree(tmp_path):
    """Wavs of three lengths (a subdirectory, an upper-case suffix), a
    stereo int16 wav and a float32 one, and a file that is not a wav."""
    (tmp_path / "d").mkdir()
    wavfile.write(str(tmp_path / "a.wav"), 16000, _signal(4000, 1))
    wavfile.write(str(tmp_path / "d" / "b.WAV"), 16000, _signal(700, 2))
    wavfile.write(str(tmp_path / "d" / "c.wav"), 8000, _signal(12345, 3))
    stereo = np.stack([_signal(900, 4), _signal(900, 5)], axis=1)
    wavfile.write(str(tmp_path / "stereo.wav"), 16000, stereo)
    wavfile.write(str(tmp_path / "float.wav"), 16000,
                  np.random.default_rng(6).uniform(-1, 1, 800)
                  .astype(np.float32))
    (tmp_path / "notes.txt").write_text("not audio")
    return tmp_path


def test_io_exports_like_jax():
    assert mfcc_tpu_torch.io.wav is wav
    assert {"wav", "transport"} <= set(dir(mfcc_tpu_torch.io))


def test_walk_wavs_matches_jax(wav_tree):
    got = wav.walk_wavs(str(wav_tree))
    assert got == jwav.walk_wavs(str(wav_tree))
    assert [os.path.basename(p) for p in got] == [
        "a.wav", "b.WAV", "c.wav", "float.wav", "stereo.wav"]


@pytest.mark.parametrize("prefer_native", [True, False],
                         ids=["native", "scipy"])
def test_read_matches_jax(wav_tree, prefer_native):
    if prefer_native and not native.available():
        pytest.skip("the native loader is not built here")
    for p in wav.walk_wavs(str(wav_tree)):
        if prefer_native and ("float" in p or "stereo" in p):
            continue               # formats the native loader refuses
        got, rate = wav.read(p, prefer_native)
        want, jrate = jwav.read(p, prefer_native)
        assert rate == jrate and got.dtype == want.dtype == np.int16, p
        assert np.array_equal(got, want), p
    s, r = wav.read(str(wav_tree / "stereo.wav"), prefer_native=False)
    assert r == 16000 and np.array_equal(s, _signal(900, 4))


@pytest.mark.parametrize("max_samples", [None, 1000])
def test_read_batch_matches_jax(wav_tree, max_samples):
    paths = [str(wav_tree / "a.wav"), str(wav_tree / "d" / "b.WAV"),
             str(wav_tree / "d" / "c.wav")]
    for prefer_native in (True, False):
        got = wav.read_batch(paths, max_samples, prefer_native)
        want = jwav.read_batch(paths, max_samples, prefer_native)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    mat, lengths, rates = got
    assert mat.shape == (3, max_samples or 12345)
    assert list(rates) == [16000, 16000, 8000]
    with pytest.raises(ValueError, match="no paths"):
        wav.read_batch([])


def _fake_device(tmp_path, samples):
    """A 'microphone': a script that writes raw int16 PCM to stdout."""
    pcm = tmp_path / "mic.pcm"
    pcm.write_bytes(np.asarray(samples, "<i2").tobytes())
    script = tmp_path / "fakemic.sh"
    script.write_text(f"#!/bin/sh\ncat {pcm}\n")
    script.chmod(0o755)
    return str(script)


def test_capture_reads_blocks(tmp_path, audio_int16):
    """The twin of the JAX package's ``test_capture_reads_blocks``: blocks
    of the requested size, shorter only at EOF, the samples in order."""
    script = _fake_device(tmp_path, audio_int16)
    with capture.Capture(command=[script]) as cap:
        a = cap.read(500)
        b = cap.read(500)
        rest = cap.read(10 ** 6)
        assert cap.read(10).size == 0
    assert len(a) == len(b) == 500 and len(rest) == len(audio_int16) - 1000
    assert np.array_equal(np.concatenate([a, b, rest]), audio_int16)
    assert cap.proc.poll() is not None


def test_capture_command_matches_jax():
    for device in (None, "hw:1"):
        assert capture.capture_command(16000, device) == \
            jcapture.capture_command(16000, device)


def test_capture_without_a_tool_raises(monkeypatch):
    monkeypatch.setattr(capture.shutil, "which", lambda name: None)
    assert capture.capture_command() is None
    with pytest.raises(RuntimeError, match="no capture tool"):
        capture.Capture()
