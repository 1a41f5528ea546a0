"""The torch package's ``FeatureServer`` on the CPU (``device="cpu"``), the
twins of the JAX package's server tests, and its ``io`` copies against the
JAX package's ``transport``.

INT frames are compared with the oracle ``int_ref.mfcc_int`` element for
element.  Every socket call and every ``join`` has a timeout of at most 60 s,
so no test can hang the suite.
"""

import logging
import socket
import threading
import time

import numpy as np
import pytest
import torch

from mfcc_tpu.io import transport as jtransport
from mfcc_tpu.ref import int_ref

from mfcc_tpu_torch import FeatureServer, MFCCConfig, StreamingMFCC
from mfcc_tpu_torch.config import RESET_WORD
from mfcc_tpu_torch.io import transport
from mfcc_tpu_torch.server import query_status, stream_samples

CFG = MFCCConfig()
TIMEOUT = 60


def _oracle(sig, cfg=CFG):
    return int_ref.mfcc_int(np.asarray(sig, np.int64), cfg).astype(np.int16)


def _read_all(sock, until=None):
    """Read until EOF, a timeout, or ``until`` frames have been decoded."""
    sock.settimeout(TIMEOUT)
    buf = b""
    while True:
        if until is not None:
            cols, _ = transport.decode_frames(buf, CFG.nceptrums)
            if len(cols) >= until:
                return cols
        try:
            data = sock.recv(65536)
        except socket.timeout:
            break
        if not data:
            break
        buf += data
    return transport.decode_frames(buf, CFG.nceptrums)[0]


@pytest.fixture
def int_server():
    srv = FeatureServer(CFG, max_streams=2, chunk=1024, device="cpu",
                        status_port=0).start()
    yield srv
    srv.stop()


def test_feature_server_roundtrip(int_server, audio_int16):
    """Wire protocol in and out, exact against the INT oracle, with a
    mid-stream reset aligned to a chunk and one that is not."""
    host, port = int_server.address
    sig = audio_int16[:1024]
    want = _oracle(sig)                                     # 4 frames
    got = stream_samples(host, port, sig, CFG.nceptrums,
                         expect_frames=len(want), timeout=TIMEOUT)
    assert np.array_equal(got[: len(want)], want)

    words = np.concatenate([transport.encode_stream(sig, reset_first=True),
                            transport.encode_stream(sig, reset_first=True)])
    with socket.create_connection((host, port), timeout=TIMEOUT) as sock:
        sock.sendall(words.astype("<u4").tobytes())
        cols = _read_all(sock, until=2 * len(want))
    assert np.array_equal(cols[: 2 * len(want)], np.concatenate([want, want]))

    pre = audio_int16[:1500]            # 1024 chunk + 476 residue
    want_pre = _oracle(pre)             # 6 frames
    words = np.concatenate([transport.encode_stream(pre, reset_first=True),
                            transport.encode_stream(sig, reset_first=True)])
    with socket.create_connection((host, port), timeout=TIMEOUT) as sock:
        sock.sendall(words.astype("<u4").tobytes())
        cols = _read_all(sock, until=len(want_pre) + len(want))
    assert np.array_equal(cols[: len(want_pre) + len(want)],
                          np.concatenate([want_pre, want]))


def test_server_status_plane(int_server, audio_int16):
    host, port = int_server.address
    shost, sport = int_server.status_address
    pong, config, lvl = query_status(shost, sport, "PING", "CONFIG",
                                     "LOGLEVEL", timeout=TIMEOUT)
    assert pong == "PONG"
    assert config["nfft"] == CFG.nfft and config["chunk"] == 1024
    assert config["max_streams"] == 2 and config["int_path"] is True
    assert lvl["loglevel"] in ("DEBUG", "INFO", "WARNING", "ERROR")

    sig = audio_int16[:1024]
    want = _oracle(sig)
    got = stream_samples(host, port, sig, CFG.nceptrums,
                         expect_frames=len(want), timeout=TIMEOUT)
    assert len(got) >= len(want)
    stats, slots = query_status(shost, sport, "STATS", "SLOTS",
                                timeout=TIMEOUT)
    assert stats["steps"] >= 1 and stats["frames_tx"] >= len(want)
    assert sum(s["tx_frames"] for s in slots) >= len(want)
    assert sum(s["rx_words"] for s in slots) >= len(sig)

    logger = logging.getLogger("mfcc_tpu_torch.server")
    old = logger.level
    try:
        (set_r,) = query_status(shost, sport, "LOGLEVEL DEBUG",
                                timeout=TIMEOUT)
        assert set_r["loglevel"] == "DEBUG"
        (err,) = query_status(shost, sport, "BOGUS", timeout=TIMEOUT)
        assert err.startswith("ERR")
    finally:
        logger.setLevel(old)


def test_server_trailing_reset_and_eof_flush(int_server, audio_int16):
    """A reset word sent alone at a recv boundary still resets the stream;
    EOF flushes the final partial chunk."""
    host, port = int_server.address
    b = audio_int16[:1500]
    got = stream_samples(host, port, b, CFG.nceptrums, timeout=TIMEOUT)
    assert np.array_equal(got, _oracle(b))

    a = audio_int16[:1024]
    want_a = _oracle(a)
    with socket.create_connection((host, port), timeout=TIMEOUT) as sock:
        sock.sendall(transport.encode_stream(a, reset_first=True)
                     .astype("<u4").tobytes())
        time.sleep(0.2)
        sock.sendall(np.array([RESET_WORD], "<u4").tobytes())
        time.sleep(0.2)
        sock.sendall(transport.encode_stream(a).astype("<u4").tobytes())
        sock.shutdown(socket.SHUT_WR)
        cols = _read_all(sock)
    assert len(cols) == 2 * len(want_a)
    assert np.array_equal(cols, np.concatenate([want_a, want_a]))


def test_server_protocol_fuzz(int_server, audio_int16):
    """Arbitrary send fragmentation x arbitrary reset placement gives the
    concatenated per-epoch oracle results."""
    rng = np.random.default_rng(99)
    base = np.tile(audio_int16, 4)
    host, port = int_server.address
    for trial in range(3):
        epochs = []
        for _ in range(int(rng.integers(1, 4))):
            ln = int(rng.integers(200, 2200))
            st = int(rng.integers(0, len(base) - ln))
            epochs.append(base[st: st + ln])
        words = [np.array([RESET_WORD], np.uint32)]
        for e in epochs[:-1]:
            words += [transport.encode_stream(e),
                      np.array([RESET_WORD], np.uint32)]
        words.append(transport.encode_stream(epochs[-1]))
        wire = np.concatenate(words).astype("<u4").tobytes()
        cuts = np.sort(rng.integers(1, len(wire), rng.integers(1, 12)))
        with socket.create_connection((host, port), timeout=TIMEOUT) as sock:
            for part in np.split(np.frombuffer(wire, np.uint8), cuts):
                sock.sendall(part.tobytes())
                if rng.random() < 0.4:
                    time.sleep(0.01)
            sock.shutdown(socket.SHUT_WR)
            got = _read_all(sock)
        outs = [_oracle(e) for e in epochs if len(e) >= CFG.nfft]
        want = (np.concatenate(outs) if outs
                else np.zeros((0, CFG.nceptrums), np.int16))
        assert np.array_equal(got, want), (trial, [len(e) for e in epochs])


def test_server_8_concurrent_clients(audio_int16):
    """Eight clients at once, each with its own signal: every client gets
    exactly its own oracle frames (slots, gather, rollback, EOF flush)."""
    N = 8
    cfg = MFCCConfig(nceptrums=16)
    srv = FeatureServer(cfg, max_streams=N, chunk=512, device="cpu").start()
    try:
        host, port = srv.address
        results, errors = [None] * N, []

        def client(i):
            try:
                local = np.roll(audio_int16, 13 * i).astype(np.int16)
                want = _oracle(local, cfg)
                got = stream_samples(host, port, local, cfg.nceptrums,
                                     expect_frames=len(want),
                                     timeout=TIMEOUT)
                results[i] = (want, got)
            except Exception as e:          # surface in the main thread
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not errors, errors[:3]
        for i, r in enumerate(results):
            assert r is not None and np.array_equal(r[1], r[0]), i
        assert srv.stats()["frames_tx"] >= N * 5
    finally:
        srv.stop()


def test_float_server_matches_streaming(audio_int16):
    """The float server (mel_floor 1.0 by default) sends clamp(round(.)) of
    ``StreamingMFCC(mel_floor=1.0)`` on the same signal; a whole number of
    chunks keeps every step a full-chunk step on both sides."""
    srv = FeatureServer(CFG, max_streams=2, chunk=512, int_path=False,
                        device="cpu").start()
    try:
        assert srv.mel_floor == 1.0 and srv._sm.mel_floor == 1.0
        host, port = srv.address
        sig = np.tile(audio_int16, 2)[: 4 * 512]
        feats, _ = StreamingMFCC(mel_floor=1.0, device="cpu").process(
            sig[None, :].astype(np.float32), 512)
        want = np.clip(np.round(feats[0]), -32768, 32767).astype(np.int16)
        got = stream_samples(host, port, sig, CFG.nceptrums,
                             timeout=TIMEOUT)
        assert len(want) == CFG.n_frames(len(sig))
        assert np.array_equal(got, want)
    finally:
        srv.stop()
    isrv = FeatureServer(CFG, int_path=True, max_streams=1, device="cpu")
    try:
        assert isrv.mel_floor == 0.0
    finally:
        isrv.stop()


def test_server_dispatch_rolls_back_idle_slots():
    """A slot that is not active in a step keeps its state exactly."""
    srv = FeatureServer(CFG, max_streams=3, chunk=600, device="cpu")
    try:
        rng = np.random.default_rng(3)
        chunks = rng.integers(-20000, 20000, (3, 600)).astype(np.int16)
        srv._dispatch(chunks, np.ones(3, bool), np.ones(3, bool),
                      np.full(3, 600, np.int32))
        before = [t.clone() for t in srv._state]
        active = np.array([True, False, True])
        chunks = rng.integers(-20000, 20000, (3, 600)).astype(np.int16)
        wire, mask, act, event = srv._dispatch(
            chunks, np.zeros(3, bool), active, np.full(3, 600, np.int32))
        assert event is None and wire.dtype == torch.int16
        for b, a in zip(before, srv._state):
            assert torch.equal(a[1], b[1])
            assert not torch.equal(a[0], b[0])
    finally:
        srv.stop()


def test_connections_share_one_reader(audio_int16):
    """64 clients at once take no thread each (one reader thread receives
    for all), each gets its own oracle frames, and every slot is released
    after its EOF flush; a slot frees for the next client."""
    N = 64
    srv = FeatureServer(CFG, max_streams=N, chunk=512, device="cpu").start()
    try:
        host, port = srv.address
        threads_before = threading.active_count()
        socks = [socket.create_connection((host, port), timeout=TIMEOUT)
                 for _ in range(N)]
        sigs = [np.roll(audio_int16, 7 * i).astype(np.int16)
                for i in range(N)]
        for sock, sig in zip(socks, sigs):
            sock.sendall(transport.encode_stream(sig, reset_first=True)
                         .astype("<u4").tobytes())
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and sum(
                1 for s_ in srv._slots if s_.conn is not None) < N:
            time.sleep(0.01)
        assert threading.active_count() <= threads_before + 2
        for sock in socks:
            sock.shutdown(socket.SHUT_WR)
        for sock, sig in zip(socks, sigs):
            got = _read_all(sock)            # until the server closes
            assert np.array_equal(got, _oracle(sig))
            sock.close()
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and any(
                s_.conn is not None for s_ in srv._slots):
            time.sleep(0.01)
        assert all(s_.conn is None for s_ in srv._slots)
        assert not srv._closing or all(
            srv._release_if_drained(c) for c in srv._closing)
        cols = stream_samples(host, port, audio_int16, 32, timeout=TIMEOUT)
        assert np.array_equal(cols, _oracle(audio_int16))
    finally:
        srv.stop()


def test_backlog_burst_is_accepted_in_order(audio_int16):
    """Connections made before ``start`` wait in the listen backlog; the
    reader accepts the burst in arrival order, one slot each, and closes
    the one that finds every slot taken."""
    N = 4
    srv = FeatureServer(CFG, max_streams=N, chunk=512, device="cpu")
    try:
        host, port = srv.address
        socks = [socket.create_connection((host, port), timeout=TIMEOUT)
                 for _ in range(N + 1)]
        srv.start()
        assert socks[N].recv(1) == b""       # rejected: closed unanswered
        sigs = [np.roll(audio_int16, 11 * i).astype(np.int16)
                for i in range(N)]
        for sock, sig in zip(socks, sigs):
            sock.sendall(transport.encode_stream(sig, reset_first=True)
                         .astype("<u4").tobytes())
            sock.shutdown(socket.SHUT_WR)
        for sock, sig in zip(socks, sigs):
            assert np.array_equal(_read_all(sock), _oracle(sig))
    finally:
        for sock in socks:
            sock.close()
        srv.stop()


def test_reset_connection_is_released(audio_int16):
    """A client that resets its connection (unread replies, SO_LINGER 0)
    ends like an EOF: its slot is flushed and released, nothing raised."""
    srv = FeatureServer(CFG, max_streams=1, chunk=512, device="cpu").start()
    try:
        host, port = srv.address
        sock = socket.create_connection((host, port), timeout=TIMEOUT)
        sock.sendall(transport.encode_stream(np.tile(audio_int16, 3))
                     .astype("<u4").tobytes())
        time.sleep(0.3)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        b"\x01\x00\x00\x00\x00\x00\x00\x00")
        sock.close()
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and srv._slots[0].conn is not None:
            time.sleep(0.01)
        assert srv._slots[0].conn is None
        cols = stream_samples(host, port, audio_int16, 32, timeout=TIMEOUT)
        assert np.array_equal(cols, _oracle(audio_int16))
    finally:
        srv.stop()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FeatureServer()


# -- the io copies against the JAX package's transport ---------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_transport_matches_jax(native):
    rng = np.random.default_rng(4)
    samples = rng.integers(-32768, 32768, 300).astype(np.int16)
    for reset_first in (False, True):
        a = transport.encode_stream(samples, reset_first)
        assert np.array_equal(a, jtransport.encode_stream(samples,
                                                          reset_first))
    words = transport.encode_stream(samples).copy()
    words[[0, 17, 150]] = RESET_WORD
    words = np.concatenate([words, [np.uint32(RESET_WORD)]])
    got, want = transport.decode_stream(words), jtransport.decode_stream(words)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for (gs, gr), (ws, wr) in zip(transport.split_resets(*got),
                                  jtransport.split_resets(*want)):
        assert np.array_equal(gs, ws) and gr == wr
    cep = rng.integers(-32768, 32768, (7, 32)).astype(np.int16)
    data = transport.encode_frames(cep, prefer_native=native)
    assert data == jtransport.encode_frames(cep, prefer_native=native)
    noisy = b"\x01\xa5" + data[:40] + b"\x00" + data + data[:50]
    got = transport.decode_frames(noisy, 32, prefer_native=native)
    want = jtransport.decode_frames(noisy, 32, prefer_native=native)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert np.array_equal(transport.decode_frames(data, 32)[0], cep)
