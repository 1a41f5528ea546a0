"""The port's live scrolling viewer (``mfcc_tpu_torch.utils.viewer``, the
recv.c role): the renderer, the follow decoder and an end-to-end run
against the port's FeatureServer on the CPU, the twins of the JAX
package's ``tests/test_viewer.py``; ``columns_to_rgb`` equal to JAX's."""

import io
import socket
import threading

import numpy as np

from mfcc_tpu.utils import viewer as jviewer

from mfcc_tpu_torch.config import MFCCConfig
from mfcc_tpu_torch.io import transport
from mfcc_tpu_torch.ref import int_ref
from mfcc_tpu_torch.server import FeatureServer
from mfcc_tpu_torch.utils import viewer

CFG = MFCCConfig()


def test_contrast_mapping_matches_reference():
    """recv.c:54-58: scale=(val+3000)*4, x=scale/65535, inferno."""
    cols = np.array([[-3000, 0, 13384]], np.int16)   # x = 0, ~0.183, 1.0
    rgb = viewer.columns_to_rgb(cols)
    lut = viewer._inferno_lut()
    assert np.array_equal(rgb[0, 0], lut[0])         # bottom of the map
    assert np.array_equal(rgb[0, 2], lut[255])       # top (clipped)
    assert np.array_equal(rgb[0, 1], lut[3000 * 4 * 255 // 65535])


def test_columns_to_rgb_matches_jax():
    cols = np.random.default_rng(2).integers(
        -32768, 32768, (40, 32)).astype(np.int16)
    got = viewer.columns_to_rgb(cols)
    assert got.dtype == np.uint8 and got.shape == (40, 32, 3)
    assert np.array_equal(got, jviewer.columns_to_rgb(cols))
    assert np.array_equal(viewer._inferno_lut(16), jviewer._inferno_lut(16))


def test_terminal_scroller_scrolls_and_reports_vad():
    out = io.StringIO()
    sc = viewer.TerminalScroller(ncep=4, height=3, out=out)
    quiet = np.zeros((2, 4), np.int16)
    loud = np.full((2, 4), 12000, np.int16)
    sc.push(quiet)
    assert "silence" in out.getvalue()
    for _ in range(40):                               # fill the VAD window
        sc.push(loud)
    text = out.getvalue()
    assert sc.n_frames == 82
    assert "VOICE" in text and "\x1b[38;2;" in text and "▀" in text
    # newest frames landed at the bottom of the ring
    assert np.array_equal(sc.ring[-1], loud[-1])
    sc.close()
    # the same pushes render the same text as JAX's scroller
    jout = io.StringIO()
    jsc = jviewer.TerminalScroller(ncep=4, height=3, out=jout)
    jsc.push(quiet)
    for _ in range(40):
        jsc.push(loud)
    jsc.close()
    assert jout.getvalue() == out.getvalue()


def test_follow_frames_resyncs_and_times_out():
    cep = np.arange(12, dtype=np.int16).reshape(3, 4)
    enc = transport.encode_frames(cep)
    # byte loss mid-stream: drop one byte of the second frame
    frame_len = len(enc) // 3
    noisy = enc[:frame_len] + enc[frame_len + 1:]
    chunks = [noisy[:5], noisy[5:], b""]
    it = iter(chunks)
    got = np.concatenate(list(viewer.follow_frames(lambda: next(it, None),
                                                   4)))
    assert len(got) == 2                              # frame 2 lost, resynced
    assert np.array_equal(got[0], cep[0])
    assert np.array_equal(got[1], cep[2])
    # an idle source ends after idle_timeout
    idle = list(viewer.follow_frames(lambda: b"", 4, poll_s=0.01,
                                     idle_timeout=0.05))
    assert idle == []


def test_live_viewer_against_feature_server(audio_int16):
    """End-to-end recv.c parity: a client of the port's FeatureServer (on
    the CPU) feeds audio while the viewer follows the same connection's
    feature stream and scrolls; the frames are the INT oracle's."""
    sig = audio_int16[:1192]
    want = int_ref.mfcc_int(sig.astype(np.int64), CFG)
    srv = FeatureServer(CFG, max_streams=1, chunk=1024, device="cpu").start()
    try:
        host, port = srv.address
        sock = socket.create_connection((host, port), timeout=60)
        words = transport.encode_stream(sig, reset_first=True)

        def feed():
            sock.sendall(words.astype("<u4").tobytes())
            sock.shutdown(socket.SHUT_WR)
        t = threading.Thread(target=feed)
        t.start()

        sock.settimeout(0.05)

        def read():
            try:
                data = sock.recv(65536)
                return data if data else None
            except TimeoutError:
                return b""
            except OSError:
                return None

        out = io.StringIO()
        sc = viewer.TerminalScroller(CFG.nceptrums, height=8, out=out)
        for cols in viewer.follow_frames(read, CFG.nceptrums,
                                         idle_timeout=30.0):
            sc.push(cols)
        t.join()
        sock.close()
        assert sc.n_frames == want.shape[0]
        assert np.array_equal(sc.ring[-want.shape[0]:],
                              want.astype(np.int16))
        assert "\x1b[38;2;" in out.getvalue()
    finally:
        srv.stop()


def test_open_source_follows_a_file(tmp_path):
    cep = np.arange(32, dtype=np.int16).reshape(2, 16)
    path = tmp_path / "feats.bin"
    path.write_bytes(transport.encode_frames(cep))
    read, close = viewer.open_source(str(path))
    try:
        got = np.concatenate(list(viewer.follow_frames(
            read, 16, poll_s=0.01, idle_timeout=0.1)))
    finally:
        close()
    assert np.array_equal(got, cep)
