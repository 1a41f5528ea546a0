"""Streaming feature server: the reference's device link, on the card.

The counterpart of ``mfcc_tpu.server``.  The reference exposes the core over
two transports -- the FT601 USB3 bulk protocol (32-bit sample words,
soft-reset bit 31, lock-step per-frame reads: software/main.c:100-165) and
the magic-framed UART link (mic2mfcc.py:56-74).  This is a TCP server
speaking the same two wire formats:

  client -> server : little-endian uint32 sample words (int16 in low half,
                     bit 31 = soft reset consumed before following samples)
  server -> client : magic-framed big-endian int16 feature columns
                     (0xa55a + ncep coefficients per frame)

Connections are mapped onto slots of ONE batched StreamingMFCC step (K4 on
the card), so any number of concurrent clients ride a single (S, chunk)
step.  Slots without a full chunk buffered are stepped with zeros and their
carry state is rolled back (one ``torch.where`` per state field), so
per-stream numerics are exactly those of an isolated stream.

The stepper thread gathers, dispatches the step, converts the features to
the int16 wire on the device and starts a non-blocking copy into pinned
host memory, recording a CUDA event; the delivery thread waits on that
event (not on the stream or the device) and sends.  The state chains from
step to step on one stream, each step writing fresh state tensors.

Activity counters (rx words / tx frames per slot) are the analogue of the
reference's BlinkerKeep RX/TX LEDs (wav2mfcc.py:38-47).
"""

from __future__ import annotations

import contextlib
import logging
import queue
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .config import MFCCConfig, DEFAULT_CONFIG
from .io import transport
from .streaming import StreamingMFCC, StreamState

# Leveled logging (the ft601 driver's log_cb role, ft601.h:34-51):
# logging.ERROR/INFO/DEBUG map to FT601_LOG_LEVEL_{ERROR,INFO,DEBUG};
# DEBUG logs word-level traffic like the MFCC_DEBUG hex dumps
# (cepstrum.c:44-65).
log = logging.getLogger("mfcc_tpu_torch.server")


@dataclass
class _Slot:
    lock: threading.Lock = field(default_factory=threading.Lock)
    pending: list = field(default_factory=list)   # [(samples, reset_first)]
    n_buffered: int = 0
    send: object = None            # callable(bytes) or None when free
    rx_words: int = 0
    tx_frames: int = 0
    reset_pending: bool = False
    eof: bool = False              # client closed its write side: flush
    in_flight: int = 0             # gathered chunks not yet delivered; a
    #   COUNTER, not a flag: the pipelined stepper can have two steps in
    #   flight for one slot, and a boolean would let the earlier delivery
    #   release the slot while the later step still owns it


class FeatureServer:
    """Batched multi-client streaming MFCC server."""

    def __init__(self, cfg: MFCCConfig = DEFAULT_CONFIG, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_streams: int = 8, chunk: int = 1024,
                 int_path: bool = True, tick_s: float = 0.005,
                 device=None, mel_floor: float | None = None,
                 pipeline_depth: int = 2,
                 transposed_chunks: bool = False,
                 status_port: int | None = None):
        """``device``: where the batched step runs; ``None`` is the card
        (``"cuda"``) and raises on a host without one; ``device="cpu"``
        runs the plain torch versions on the host (small dev servers,
        tests).

        ``mel_floor``: float-path silence clamp.  None (default) resolves
        to 1.0 on the float path -- a SERVER must never emit NaN/inf
        features for a client that streams digital silence, so it deviates
        from the notebook spec the same way the RTL does (0 -> 1 before
        log2, mfcc/core/log.py:123-126).  Pass 0.0 explicitly for
        notebook-spec -inf behavior.  Ignored on the INT path (already
        RTL-clamped).

        ``pipeline_depth``: max dispatched-but-undelivered steps.  With the
        dedicated delivery thread the device computes step k+1 while step
        k's results cross to the host and onto the TCP sockets.

        ``transposed_chunks``: gather client samples into a (C, S)
        positions-major buffer (plain column writes on the host), which
        the kernel reads in place.

        ``status_port``: when not None, serve the control/status register
        plane on a second TCP port (0 = ephemeral; address in
        ``self.status_address``) -- the role of the reference's
        FT601WishboneBridge (mfcc/io/ft601.py:214-330), which maps register
        reads/writes onto the same USB3 link.  The registers are the
        observability counters the server already keeps; see
        _handle_status_conn for the line protocol."""
        self.cfg = cfg
        self.chunk = chunk
        self.int_path = int_path
        self.max_streams = max_streams
        self.transposed_chunks = transposed_chunks
        if mel_floor is None:
            mel_floor = 0.0 if int_path else 1.0
        self.mel_floor = mel_floor
        self._sm = StreamingMFCC(cfg, int_path=int_path, device=device,
                                 mel_floor=mel_floor,
                                 transposed_chunks=transposed_chunks)
        self.device = self._sm.device
        self._state = self._sm.init(max_streams)
        self._slots = [_Slot() for _ in range(max_streams)]
        self._stop = threading.Event()
        self._data = threading.Event()     # set when a slot buffers data
        self._tick_s = tick_s
        # stepper-loop occupancy instrumentation: cumulative wall seconds
        # inside gather / dispatch / delivery
        self._stats = {"steps": 0, "idle_ticks": 0, "gather_s": 0.0,
                       "compute_s": 0.0, "deliver_s": 0.0, "frames_tx": 0}
        self._stats_lock = threading.Lock()
        # dispatched-but-undelivered steps; put() blocking when full is the
        # backpressure that bounds device-side divergence from delivery
        self._outq = queue.Queue(maxsize=max(1, pipeline_depth))

        srv = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                srv._handle_conn(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # the listen backlog: socketserver's default of 5 resets
            # connections when many clients connect at once
            request_queue_size = 128

        self._tcp = Server((host, port), Handler)
        self.address = self._tcp.server_address

        self._status_tcp = None
        self.status_address = None
        if status_port is not None:
            class StatusHandler(socketserver.StreamRequestHandler):
                def handle(self):
                    srv._handle_status_conn(self)

            self._status_tcp = Server((host, status_port), StatusHandler)
            self.status_address = self._status_tcp.server_address

    # -- connection side ------------------------------------------------------

    def _alloc_slot(self, send):
        for i, s in enumerate(self._slots):
            with s.lock:
                if s.send is None:
                    s.send = send
                    s.pending.clear()
                    s.n_buffered = 0
                    s.rx_words = 0
                    s.tx_frames = 0
                    s.reset_pending = True   # fresh stream = reset carry
                    s.eof = False
                    s.in_flight = 0
                    return i
        return -1

    def _handle_conn(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_lock = threading.Lock()

        def send(data: bytes):
            with send_lock:
                try:
                    sock.sendall(data)
                except OSError:
                    pass

        idx = self._alloc_slot(send)
        if idx < 0:
            log.error("connection rejected: all %d slots busy",
                      self.max_streams)
            sock.close()
            return
        log.info("client connected -> slot %d", idx)
        slot = self._slots[idx]
        tail = b""
        try:
            while not self._stop.is_set():
                data = sock.recv(65536)
                if not data:
                    break
                buf = tail + data
                usable = len(buf) - (len(buf) % 4)
                words = np.frombuffer(buf[:usable], dtype="<u4")
                tail = buf[usable:]
                if len(words) == 0:
                    continue
                samples, resets, trailing_reset = \
                    transport.decode_stream(words)
                if log.isEnabledFor(logging.DEBUG):
                    log.debug("slot %d rx %d words: %s%s", idx, len(words),
                              " ".join(f"{w:08x}" for w in words[:8]),
                              " ..." if len(words) > 8 else "")
                with slot.lock:
                    slot.rx_words += len(words)
                    # split at reset points so resets land on chunk starts;
                    # a trailing reset word at the recv boundary becomes a
                    # zero-length reset-first sentinel, preserving arrival
                    # order after already-buffered samples (the reference
                    # host sends the reset as its own 4-byte write,
                    # software/main.c mfcc_softreset)
                    for s_arr, reset_first in transport.split_resets(
                            samples, resets, trailing_reset):
                        slot.pending.append((s_arr, reset_first))
                        slot.n_buffered += len(s_arr)
                self._data.set()   # wake the stepper (event-driven ticks)
            # client closed its write side: flush the residual (< chunk)
            # samples through a length-limited step, then release the slot
            # (no silent partial-chunk drop)
            with slot.lock:
                slot.eof = True
            deadline = time.time() + 30.0
            while time.time() < deadline and not self._stop.is_set():
                with slot.lock:
                    # drained means: nothing buffered AND no gathered chunk
                    # still being computed/sent by the stepper
                    if slot.n_buffered == 0 and not slot.pending \
                            and slot.in_flight == 0:
                        break
                time.sleep(self._tick_s)
        finally:
            with slot.lock:
                slot.send = None
                slot.eof = False
            log.info("client on slot %d disconnected (rx=%d words, "
                     "tx=%d frames)", idx, slot.rx_words, slot.tx_frames)
            try:
                sock.close()
            except OSError:
                pass

    # -- control/status plane -------------------------------------------------

    def _handle_status_conn(self, handler):
        """One status-plane connection: newline-delimited commands, one JSON
        (or bare-word) reply line per command -- the register read/write
        semantics of the reference's Wishbone bridge
        (mfcc/io/ft601.py:214-330: a read command returns
        the register value, a write sets it), with the registers being the
        server's live observability state:

          PING              -> PONG                     (link probe)
          STATS             -> stepper occupancy counters (stats())
          SLOTS             -> per-slot {active, rx_words, tx_frames,
                               buffered, in_flight}     (the RX/TX LEDs)
          CONFIG            -> frame geometry + serving parameters
          LOGLEVEL [LEVEL]  -> read, or set (DEBUG|INFO|WARNING|ERROR),
                               the server log level    (the control write)
        """
        import json
        try:
            for raw in handler.rfile:
                parts = raw.decode("ascii", "replace").split()
                cmd = parts[0].upper() if parts else ""
                if cmd == "PING":
                    reply = "PONG"
                elif cmd == "STATS":
                    reply = json.dumps(self.stats())
                elif cmd == "SLOTS":
                    reply = json.dumps([
                        {"active": s.send is not None, "rx_words": s.rx_words,
                         "tx_frames": s.tx_frames, "buffered": s.n_buffered,
                         "in_flight": s.in_flight} for s in self._slots])
                elif cmd == "CONFIG":
                    c = self.cfg
                    reply = json.dumps({
                        "nfft": c.nfft, "hop": c.hop,
                        "samplerate": c.samplerate, "nfilters": c.nfilters,
                        "nceptrums": c.nceptrums, "chunk": self.chunk,
                        "max_streams": self.max_streams,
                        "int_path": self.int_path,
                        "mel_floor": self.mel_floor})
                elif cmd == "LOGLEVEL":
                    if len(parts) > 1:
                        lvl = logging.getLevelName(parts[1].upper())
                        if isinstance(lvl, int):
                            log.setLevel(lvl)
                            reply = json.dumps(
                                {"loglevel": logging.getLevelName(
                                    log.getEffectiveLevel())})
                        else:
                            reply = f"ERR unknown level {parts[1]}"
                    else:
                        reply = json.dumps(
                            {"loglevel": logging.getLevelName(
                                log.getEffectiveLevel())})
                elif cmd in ("QUIT", "EXIT", ""):
                    break
                else:
                    reply = f"ERR unknown command {cmd}"
                handler.wfile.write(reply.encode() + b"\n")
                handler.wfile.flush()
        except OSError:
            pass

    # -- batched stepper ------------------------------------------------------

    def _gather(self):
        """Collect one chunk per ready slot -> (chunks, resets, active,
        lengths).  An EOF'd slot with a residual partial run is flushed as a
        zero-padded chunk with an explicit sample length."""
        C = self.chunk
        S = self.max_streams
        # int16 is the wire dtype AND the INT kernel's native ingest: half
        # the bytes of int32 to copy to the card
        shape = (C, S) if self.transposed_chunks else (S, C)
        chunks = np.zeros(shape, dtype=np.int16 if self.int_path
                          else np.float32)
        resets = np.zeros(S, dtype=bool)
        active = np.zeros(S, dtype=bool)
        lengths = np.full(S, C, dtype=np.int32)
        for i, slot in enumerate(self._slots):
            if slot.send is None:     # racy-but-benign fast skip (GIL read;
                continue              # _alloc_slot confirms under the lock)
            with slot.lock:
                if slot.send is None:
                    continue
                # a residual run is flushable once something bounds it: a
                # full chunk, client EOF, or a reset word that arrived AFTER
                # buffered samples (e.g. a file boundary -- the run's frames
                # must be emitted without waiting for more input)
                bounded = any(r and j > 0
                              for j, (_, r) in enumerate(slot.pending))
                if slot.n_buffered < C and not slot.eof and not bounded:
                    continue
                # A chunk holds samples of ONE reset epoch.  In hardware,
                # frames complete continuously as samples arrive, and a soft
                # reset drops only the in-flight partial window
                # (ResetInserter, mfcc.py:116).  Matching that: when a reset
                # word arrives mid-fill, the pre-reset run is FLUSHED as a
                # length-limited chunk (its completable frames are emitted),
                # and the reset epoch starts on the next gather.
                got = 0
                reset_first = slot.reset_pending
                slot.reset_pending = False
                row = chunks[:, i] if self.transposed_chunks else chunks[i]
                while got < C and slot.pending:
                    s_arr, seg_reset = slot.pending[0]
                    if seg_reset:
                        if got:           # flush the pre-reset run first
                            break
                        reset_first = True
                        slot.pending[0] = (s_arr, False)
                        continue
                    take = min(C - got, len(s_arr))
                    row[got: got + take] = s_arr[:take]
                    got += take
                    if take == len(s_arr):
                        slot.pending.pop(0)
                    else:
                        slot.pending[0] = (s_arr[take:], False)
                if got < C:
                    if got and (slot.pending or slot.eof):
                        # run bounded by a reset word (pending head) or by
                        # EOF: flush as a length-limited chunk (padding is
                        # masked out, carry keeps only real samples)
                        lengths[i] = got
                    else:
                        # not enough data yet: put the run back intact
                        if got:
                            slot.pending.insert(
                                0, (row[:got].copy()
                                    .astype(chunks.dtype), False))
                            row[:got] = 0
                        slot.reset_pending = reset_first
                        continue
                slot.n_buffered -= got
                resets[i] = reset_first
                active[i] = True
                slot.in_flight += 1
        return chunks, resets, active, lengths

    def _step_once(self) -> bool:
        """One stepper tick: gather + dispatch (async device work + async
        host copy begin), then hand the device handles to the delivery
        thread.  Up to ``pipeline_depth`` steps stay in flight: the device
        computes step k+2 while step k+1's results cross the wire and step
        k's frames are on the sockets.  The state chains step-to-step on
        the device, so the host never waits on it.  A slot's in_flight
        count holds from gather until ITS delivery."""
        t0 = time.perf_counter()
        chunks, resets, active, lengths = self._gather()
        t1 = time.perf_counter()
        dispatched = None
        if active.any():
            try:
                dispatched = self._dispatch(chunks, resets, active, lengths)
            except Exception:
                log.exception("stepper: batched dispatch failed")
                self._clear_busy(active)
        t2 = time.perf_counter()
        with self._stats_lock:
            self._stats["gather_s"] += t1 - t0
            self._stats["compute_s"] += t2 - t1
            if dispatched is None:
                self._stats["idle_ticks"] += 1
        if dispatched is not None:
            while not self._stop.is_set():     # blocking put = backpressure
                try:
                    self._outq.put(dispatched, timeout=0.25)
                    break
                except queue.Full:
                    continue
        return dispatched is not None

    def _run_delivery(self):
        """Delivery thread: blocking host readback + per-slot sends, fully
        overlapped with the stepper's gather/dispatch of later steps."""
        while True:
            try:
                item = self._outq.get(timeout=self._tick_s)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            t0 = time.perf_counter()
            try:
                self._deliver(*item)
            except Exception:
                log.exception("delivery: failed")
                self._clear_busy(item[2])
            with self._stats_lock:
                self._stats["deliver_s"] += time.perf_counter() - t0
                self._stats["steps"] += 1
            self._outq.task_done()

    def _clear_busy(self, active):
        for i, slot in enumerate(self._slots):
            if active[i]:
                with slot.lock:
                    slot.in_flight -= 1

    def _device_ctx(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """Start the copy of ``t`` to the host: on the card, a non-blocking
        copy into pinned memory (complete once the step's event is)."""
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _dispatch(self, chunks, resets, active, lengths):
        """Enqueue the batched step, the inactive-slot state rollback, the
        int16 wire conversion and the copies to the host on the device
        (asynchronously); returns (wire, mask, active, event), the event
        recorded after the copies (None on the CPU)."""
        # all-full-chunk ticks (the steady serving state) take the fused
        # kernel; only ticks containing a flush (EOF / pre-reset run) pay
        # the length-masked chain step
        lens = None if (lengths == self.chunk).all() else lengths
        with self._device_ctx():
            feats, mask, new_state = self._sm.step(chunks, self._state,
                                                   resets, lengths=lens)
            # roll back the state of inactive slots (they were fed zeros);
            # each field is a fresh tensor, nothing is updated in place
            act = torch.as_tensor(active, device=self.device)
            self._state = StreamState(*(
                torch.where(act.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                for n, o in zip(new_state, self._state)))
            # wire format on the device: int16 is 2x (INT) to 4x (float)
            # less to copy back than the features
            if feats.is_floating_point():
                feats = torch.round(feats)
            wire = torch.clamp(feats, -32768, 32767).to(torch.int16)
            wire, mask = self._to_host(wire), self._to_host(mask)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        return wire, mask, active, event

    def _deliver(self, wire, mask, active, event):
        """Wait for a dispatched step's copies (its event), then the
        per-slot sends and the busy release."""
        if event is not None:
            event.synchronize()
        wire, mask = wire.numpy(), mask.numpy()
        for i, slot in enumerate(self._slots):
            if not active[i]:
                continue
            cols = wire[i][mask[i]]
            if len(cols):
                data = transport.encode_frames(cols)
                # count BEFORE the send: an observer who has received the
                # frames must see them counted
                with self._stats_lock:
                    self._stats["frames_tx"] += len(cols)
                with slot.lock:
                    send = slot.send
                    slot.tx_frames += len(cols)
                if send is not None:
                    send(data)
        self._clear_busy(active)

    def _run_stepper(self):
        while not self._stop.is_set():
            try:
                self._data.clear()
                stepped = self._step_once()
            except Exception:
                # a failing tick must not kill the serving loop
                log.exception("stepper: tick failed")
                stepped = False
            if not stepped:
                # wait for data instead of polling the slot scan; the
                # timeout bounds EOF-flush latency (a not-yet-ready slot
                # becomes flushable with no new bytes arriving)
                self._data.wait(self._tick_s)

    # -- lifecycle -------------------------------------------------------------

    def warmup(self):
        """Run both step kinds once before accepting traffic: the
        full-chunk (kernel) step and the length-masked flush step; on the
        card the first runs build the kernels (nvcc, seconds)."""
        C, S = self.chunk, self.max_streams
        dummy = np.zeros((C, S) if self.transposed_chunks else (S, C),
                         dtype=np.int16 if self.int_path else np.float32)
        with self._device_ctx():
            for lengths in (None, np.full(S, C, np.int32)):
                feats, _, _ = self._sm.step(dummy, self._state,
                                            np.zeros(S, dtype=bool),
                                            lengths=lengths)
                feats.cpu()
        return self

    def start(self, warmup: bool = True):
        if warmup:
            self.warmup()
        self._threads = [
            threading.Thread(target=self._tcp.serve_forever, daemon=True),
            threading.Thread(target=self._run_stepper, daemon=True),
            threading.Thread(target=self._run_delivery, daemon=True),
        ]
        if self._status_tcp is not None:
            self._threads.append(threading.Thread(
                target=self._status_tcp.serve_forever, daemon=True))
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        """Stop serving and join the server's threads (each for at most
        10 s)."""
        self._stop.set()
        # BaseServer.shutdown() blocks on an event that only serve_forever
        # sets -- calling it on a never-started server hangs forever
        if getattr(self, "_threads", None):
            self._tcp.shutdown()
            if self._status_tcp is not None:
                self._status_tcp.shutdown()
            for t in self._threads:
                t.join(10.0)
        self._tcp.server_close()
        if self._status_tcp is not None:
            self._status_tcp.server_close()

    def activity(self):
        """Per-slot (rx_words, tx_frames) -- the RX/TX LED equivalent."""
        return [(s.rx_words, s.tx_frames) for s in self._slots]

    def stats(self):
        """Stepper-loop occupancy counters: steps, idle_ticks, cumulative
        seconds in the per-slot gather scan vs the batched compute+send,
        and total frames sent (the serial-bottleneck observables)."""
        return dict(self._stats)


# -- client helpers ------------------------------------------------------------


def query_status(host: str, port: int, *commands: str,
                 timeout: float = 10.0):
    """Issue commands on a FeatureServer's status plane; returns the list
    of decoded replies (dict/list for JSON replies, str for bare words).
    The client half of the Wishbone-bridge register access."""
    import json
    replies = []
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.settimeout(timeout)
        f = sock.makefile("rwb")
        for cmd in commands:
            f.write(cmd.encode() + b"\n")
            f.flush()
            line = f.readline().decode().strip()
            try:
                replies.append(json.loads(line))
            except json.JSONDecodeError:
                replies.append(line)
    return replies

def stream_samples(host: str, port: int, samples: np.ndarray, ncep: int, *,
                   reset_first: bool = True, expect_frames: int | None = None,
                   timeout: float = 60.0, eof: bool = True) -> np.ndarray:
    """Send int16 samples to a FeatureServer, return decoded feature columns.

    With ``eof=True`` (default) the write side is shut down after sending, so
    the server flushes the final partial chunk and the read loop terminates
    on server close instead of waiting out the timeout.  The buffer is
    trimmed by ``consumed`` after each decode, so cost stays linear in the
    stream length."""
    words = transport.encode_stream(np.asarray(samples, np.int16),
                                    reset_first=reset_first)
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(words.astype("<u4").tobytes())
        if eof:
            sock.shutdown(socket.SHUT_WR)
        sock.settimeout(timeout)
        buf = b""
        frames = []
        n_frames = 0
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                data = sock.recv(65536)
            except socket.timeout:
                break
            if not data:
                break
            buf += data
            cols, consumed = transport.decode_frames(buf, ncep)
            buf = buf[consumed:]
            if len(cols):
                frames.append(cols)
                n_frames += len(cols)
            if expect_frames is not None and n_frames >= expect_frames:
                break
        return (np.concatenate(frames) if frames
                else np.zeros((0, ncep), np.int16))
