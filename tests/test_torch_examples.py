"""The port's examples (``mfcc_tpu_torch.examples``), each ``main`` in
process with ``--backend cpu`` at small sizes: their outputs against the
oracles and, for ``int_walkthrough``, line for line against the JAX
package's walkthrough on the same synthetic input."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from mfcc_tpu_torch.config import MFCCConfig
from mfcc_tpu_torch.examples import (int_walkthrough, quickstart,
                                     server_loadtest, serving_demo)
from mfcc_tpu_torch.io import transport
from mfcc_tpu_torch.ref import int_ref
from mfcc_tpu_torch.server import FeatureServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--backend", "cpu"]


def test_quickstart(capsys):
    assert quickstart.main(CPU) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("using a synthetic 1 s chirp")
    assert out[1].startswith("float cepstra: (92, 32)  c0 range [")
    assert out[2:] == [
        "int cepstra:   (92, 32)  (bit-exact vs the reference RTL)",
        "voice activity: True",
        # 1024 samples complete floor((1024 - 512) / 170) + 1 = 4 frames,
        # leaving 1024 - 4 * 170 = 344 in the carry
        "streaming step: 4 frames emitted, carry count = 344 samples",
        "drain: 3 residual frames flushed",
        out[6],
        "batch of 2 streams -> (2, 92, 32)"]
    assert out[6].startswith("liftered c1 of frame 0: ")


def test_quickstart_reads_a_wav(tmp_path, audio_int16, capsys):
    from scipy.io import wavfile
    p = tmp_path / "a.wav"
    wavfile.write(str(p), 16000, audio_int16)
    assert quickstart.main([str(p), *CPU]) == 0
    out = capsys.readouterr().out
    assert f"loaded {p}: 1192 samples @ 16000 Hz" in out
    assert "int cepstra:   (5, 32)" in out


def _jax_walkthrough():
    spec = importlib.util.spec_from_file_location(
        "jax_int_walkthrough", os.path.join(REPO, "examples",
                                            "int_walkthrough.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_int_walkthrough_matches_jax(tmp_path, capsys, monkeypatch):
    """Every stage's line equals the JAX walkthrough's on the same input
    (the synthetic tone: ``--wav`` names no file); the last cross-check
    holds the port's ``MFCC().int`` (JAX's there) to the oracle."""
    args = ["--frames", "4", "--wav", str(tmp_path / "none.wav")]
    jmod = _jax_walkthrough()
    monkeypatch.setattr(sys, "argv", ["int_walkthrough.py", *args])
    jmod.main()
    want = capsys.readouterr().out.splitlines()
    assert int_walkthrough.main([*args, *CPU]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) > 40
    assert got[:-1] == want[:-1]
    assert want[-1] == "  TPU pipeline == oracle: True (element-exact)"
    assert got[-1] == "  cpu pipeline == oracle: True (element-exact)"


def test_int_walkthrough_plots(tmp_path, capsys):
    plots = tmp_path / "plots"
    assert int_walkthrough.main(["--frames", "2", "--plots", str(plots),
                                 *CPU]) == 0
    assert sorted(os.listdir(plots)) == [
        "1-preemph.png", "3-window.png", "4-fft.png", "5-power.png",
        "6-mel.png", "7-log.png", "8-cepstra.png"]
    assert "plots saved to" in capsys.readouterr().out


def test_serving_demo(capsys):
    assert serving_demo.main(["3", "0.25", *CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "starting server (3 slots, building the batch step)..."
    assert out[1:4] == [f"client {k}: 21 frames bit-exact" for k in range(3)]
    assert out[4].startswith("3 concurrent streams x 0.2 s audio "
                             "(63 frames) served in ")


def test_server_loadtest_main(capsys):
    assert server_loadtest.main(["--streams", "4", "--seconds", "1",
                                 *CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# starting server: 4 slots, chunk=1024, "
                             "int path, device=cpu")
    assert out[1] == "streams=4 chunk=1024 path=int device=cpu"
    assert out[2].startswith("sustained: ")
    assert out[3].startswith("latency: p50=")
    assert out[4].startswith("stepper: ")


def test_server_loadtest_clients_get_the_oracle():
    """``run_clients`` against the port's FeatureServer on the CPU: each
    client's stream is the example's chunk repeated, and the features it
    received are the INT oracle's on the samples it sent (the flush of its
    partial chunk at the end included)."""
    cfg = MFCCConfig(nceptrums=16)
    C, N = 512, 3
    srv = FeatureServer(cfg, max_streams=N, chunk=C, device="cpu").start()
    try:
        run = server_loadtest.run_clients(*srv.address, N, C, 0.6,
                                          cfg.nceptrums)
    finally:
        srv.stop()
    sig = server_loadtest.client_signal(C)
    assert len(run["sent"]) == len(run["received"]) == N
    for sent, received in zip(run["sent"], run["received"]):
        stream = np.resize(sig, sent // 4)        # whole words sent
        cols, _ = transport.decode_frames(received, cfg.nceptrums)
        want = int_ref.mfcc_int(stream.astype(np.int64), cfg)
        assert len(cols) == len(want) > 0
        assert np.array_equal(cols, want.astype(np.int16))
    summary = server_loadtest.summarize(run, N, cfg.nceptrums)
    assert summary["frames"] > 0 and summary["fps"] > 0
    assert 0 <= summary["p50_ms"] <= summary["p99_ms"]


@pytest.mark.parametrize("name", ["quickstart", "int_walkthrough",
                                  "serving_demo", "server_loadtest"])
def test_examples_run_on_the_card_by_default(name):
    """Without ``--backend cpu`` an example asks for the card, and on a
    host without one exits non-zero naming ``--backend cpu``."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    mod = {"quickstart": quickstart, "int_walkthrough": int_walkthrough,
           "serving_demo": serving_demo,
           "server_loadtest": server_loadtest}[name]
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert "--backend cpu" in str(e.value.code)
