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

One reader thread accepts and receives for every connection (a
selector over the listening socket and the clients'): there is no thread
per connection, and a burst of connections is accepted in one pass.  The
stepper wakes when a slot becomes gatherable (a full chunk, a reset, an
EOF), not on every receive.  With a thread per connection and a wake per
receive, a thousand real-time clients kept the stepper from the
interpreter lock (every wake scans every slot) and the server delivered
nothing; an accepting thread of its own took the interpreter lock once a
connection.  An EOF'd connection is released by the delivery that drains
its slot, not by a poll.

Activity counters (rx words / tx frames per slot) are the analogue of the
reference's BlinkerKeep RX/TX LEDs (wav2mfcc.py:38-47).

Each thread's time is split by always-on counters (``stats()``): the
stepper's into gather, dispatch, backpressure and wait; the delivery's into
readback wait, encode, send and release; the reader's work apart from its
wait in ``select``; and each thread's CPU time.  With ``trace_capacity``
above 0 the server also keeps a bounded ring of spans -- each phase of each
thread and each chunk's path from its slot to its send -- exported on the
epoch clock of ``torch.profiler``'s events (``trace_events``, the status
plane's ``TRACE``), so that both load as one timeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import queue
import selectors
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

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
    # [(samples, reset_first, arrival ns)]: the perf_counter_ns() of the
    # recv that brought the segment travels with it
    pending: list = field(default_factory=list)
    n_buffered: int = 0
    rx_words: int = 0
    tx_frames: int = 0
    reset_pending: bool = False
    eof: bool = False              # client closed its write side: flush
    eof_ns: int = 0                # perf_counter_ns() of that EOF
    seq: int = 0                   # chunks gathered since the connection
    conn: object = None            # the slot's _Conn, None when free
    in_flight: int = 0             # gathered chunks not yet delivered; a
    #   COUNTER, not a flag: the pipelined stepper can have two steps in
    #   flight for one slot, and a boolean would let the earlier delivery
    #   release the slot while the later step still owns it


class _Conn:
    """A client connection: its socket, slot, the bytes of an incomplete
    word, and when its EOF arrived (None before)."""
    __slots__ = ("sock", "idx", "tail", "eof_at", "_send_lock")

    def __init__(self, sock: socket.socket):
        self.sock, self.idx, self.tail, self.eof_at = sock, -1, b"", None
        self._send_lock = threading.Lock()

    def send(self, data: bytes) -> None:
        with self._send_lock:
            try:
                self.sock.sendall(data)
            except OSError:
                pass


class _Step(NamedTuple):
    """What travels with a dispatched step to its delivery: its id, the
    perf_counter_ns() at the end of its dispatch (its time in the queue
    runs from there), and, with the span ring on, (slot, seq, whole ns,
    taken ns) of each chunk it carries, in slot order (None otherwise)."""
    id: int
    t_put: int
    chunks: list | None


class _Spans:
    """The span ring: a bounded deque of span records stamped with
    ``time.perf_counter_ns()``, and one anchor pair that puts them on the
    epoch clock of ``torch.profiler``'s events.

    A record is ``(id, name, start_ns, end_ns, thread, step, slot, seq,
    parent)``: ``thread`` is "stepper", "delivery" or "reader", or the
    track of a span that crosses threads ("outq" for a step's wait in the
    queue, "chunk" for a chunk's path and its wait in its slot); -1 where
    a field does not apply, ``parent`` 0 for none."""

    def __init__(self, capacity: int):
        self.records = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        p0 = time.perf_counter_ns()
        epoch = time.time_ns()
        p1 = time.perf_counter_ns()
        self.offset_ns = epoch - (p0 + p1) // 2   # epoch ns - perf ns
        self.threads = {}                        # thread -> native id

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, name, t0, t1, thread, step=-1, slot=-1, seq=-1,
            parent=0, sid=0) -> None:
        self.records.append((sid or next(self._ids), name, t0, t1, thread,
                             step, slot, seq, parent))


# the tracks of the spans that cross threads, clear of any thread id: a
# slot's chunks at _TRACKS + slot, the queue's lanes below _TRACKS
_TRACKS = 1 << 30


class FeatureServer:
    """Batched multi-client streaming MFCC server."""

    def __init__(self, cfg: MFCCConfig = DEFAULT_CONFIG, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_streams: int = 8, chunk: int = 1024,
                 int_path: bool = True, tick_s: float = 0.005,
                 device=None, mel_floor: float | None = None,
                 pipeline_depth: int = 2,
                 transposed_chunks: bool = False,
                 status_port: int | None = None,
                 trace_capacity: int = 0):
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
        _handle_status_conn for the line protocol.

        ``trace_capacity``: when above 0, keep the last that many spans
        (each thread's phases, each chunk's path) in memory for
        ``trace_events``; 0 (default) records none and allocates
        nothing."""
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
        # occupancy counters, cumulative (seconds of wall or CPU time,
        # counts; see stats()): each thread writes only its own dict, so
        # none takes a lock that the others would queue on
        self._stepper_counts = {"idle_ticks": 0, "chunks": 0, **dict.fromkeys(
            ("gather_s", "compute_s", "backpressure_s", "wait_s",
             "slot_wait_s", "stepper_cpu_s"), 0.0)}
        self._delivery_counts = {"steps": 0, "frames_tx": 0, **dict.fromkeys(
            ("deliver_s", "outq_wait_s", "readback_wait_s", "encode_s",
             "send_s", "delivery_cpu_s"), 0.0)}
        self._reader_counts = {"recvs": 0, "reader_s": 0.0,
                               "reader_cpu_s": 0.0}
        self._spans = _Spans(trace_capacity) if trace_capacity > 0 else None
        self._next_step = 0                # the stepper's step ids
        self._delivering = None            # the _Step the delivery is on
        # dispatched-but-undelivered steps; put() blocking when full is the
        # backpressure that bounds device-side divergence from delivery
        self._outq = queue.Queue(maxsize=max(1, pipeline_depth))
        # one selector for the listening socket and every client
        # connection, served by the reader thread; the listen backlog holds
        # a thousand clients that connect at once (socketserver's default
        # of 5 resets them)
        self._sel = selectors.DefaultSelector()
        self._listener = socket.create_server((host, port), backlog=1024)
        self._listener.setblocking(False)
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._closing = []                 # EOF'd connections not released
        self.address = self._listener.getsockname()[:2]

        srv = self

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            request_queue_size = 128

        self._status_tcp = None
        self.status_address = None
        if status_port is not None:
            class StatusHandler(socketserver.StreamRequestHandler):
                def handle(self):
                    srv._handle_status_conn(self)

            self._status_tcp = Server((host, status_port), StatusHandler)
            self.status_address = self._status_tcp.server_address

    # -- connection side ------------------------------------------------------

    def _alloc_slot(self, conn: "_Conn"):
        for i, s in enumerate(self._slots):
            with s.lock:
                if s.conn is None:
                    s.conn, conn.idx = conn, i
                    s.pending.clear()
                    s.n_buffered = 0
                    s.rx_words = 0
                    s.tx_frames = 0
                    s.reset_pending = True   # fresh stream = reset carry
                    s.eof = False
                    s.seq = 0
                    s.in_flight = 0
                    return i
        return -1

    def _accept_all(self) -> None:
        """Accept every connection waiting in the listen backlog (the
        reader thread, when the listening socket is readable)."""
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                # the peer gave up in the backlog, or descriptors ran out:
                # the rest wait for the next readiness
                log.exception("accept failed")
                return
            self._accept_conn(sock)

    def _accept_conn(self, sock: socket.socket):
        """A new connection: take a slot and register the socket with the
        reader thread's selector.  No thread per connection: one reader
        thread receives for every connection, so that a thousand connections
        do not contend with the stepper for the interpreter lock."""
        sock.setblocking(True)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock)
        idx = self._alloc_slot(conn)
        if idx < 0:
            log.error("connection rejected: all %d slots busy",
                      self.max_streams)
            sock.close()
            return
        log.info("client connected -> slot %d", idx)
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _eof(self, conn: "_Conn") -> None:
        """The client closed its write side (or the connection failed): the
        stepper flushes the residual (< chunk) samples through a
        length-limited step, then the slot is released (no silent
        partial-chunk drop)."""
        self._unregister(conn.sock)
        slot = self._slots[conn.idx]
        with slot.lock:
            slot.eof = True
            slot.eof_ns = time.perf_counter_ns()
        conn.eof_at = time.time()
        self._closing.append(conn)
        self._data.set()
        self._release_if_drained(conn)

    def _release_if_drained(self, conn: "_Conn", force: bool = False
                            ) -> bool:
        """Release an EOF'd connection's slot and close it once nothing is
        buffered and no gathered chunk is still being computed or sent (or
        when ``force``); True once released."""
        slot = self._slots[conn.idx]
        with slot.lock:
            if slot.conn is not conn:
                return True
            if not force and (slot.n_buffered or slot.pending
                              or slot.in_flight):
                return False
            slot.conn = None
            slot.eof = False
        log.info("client on slot %d disconnected (rx=%d words, tx=%d "
                 "frames)", conn.idx, slot.rx_words, slot.tx_frames)
        try:
            conn.sock.close()
        except OSError:
            pass
        return True

    def _reap(self) -> None:
        """Release the EOF'd connections that drained, and any left after
        30 s (a stepper that cannot flush them must not hold their slots
        for ever)."""
        now = time.time()
        self._closing = [
            c for c in self._closing
            if not self._release_if_drained(c, force=now - c.eof_at > 30.0)]

    def _unregister(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            pass

    def _run_reader(self):
        """Reader thread: accept the waiting connections, receive from
        every readable one, and release the EOF'd ones that drained.  Its
        time outside ``select`` is ``reader_s``."""
        self._name_thread("reader")
        cpu0 = time.thread_time()
        while not self._stop.is_set():
            try:
                events = self._sel.select(timeout=0.25)
            except (OSError, ValueError):
                if self._stop.is_set():
                    return
                continue
            t0 = time.perf_counter_ns()
            recvs = 0
            for key, _ in events:
                if key.data is None:           # the listening socket
                    self._accept_all()
                    continue
                recvs += 1
                try:
                    self._receive(key.data)
                except Exception:
                    # one connection's fault must not stop the others
                    log.exception("reader: slot %d", key.data.idx)
                    self._eof(key.data)
            if self._closing:
                self._reap()
            t1 = time.perf_counter_ns()
            cpu1 = time.thread_time()
            st = self._reader_counts
            st["reader_s"] += (t1 - t0) / 1e9
            st["recvs"] += recvs
            st["reader_cpu_s"] += cpu1 - cpu0
            cpu0 = cpu1

    def _receive(self, conn: "_Conn"):
        """One recv on a readable connection: decode the sample words into
        its slot, or mark its EOF (a reset connection ends like one).  The
        recv's start stamps the segments it brings."""
        t0 = time.perf_counter_ns()
        try:
            data = conn.sock.recv(65536)
        except BlockingIOError:
            return
        except OSError:
            data = b""
        if not data:
            self._eof(conn)
            return
        idx, slot = conn.idx, self._slots[conn.idx]
        buf = conn.tail + data
        usable = len(buf) - (len(buf) % 4)
        words = np.frombuffer(buf[:usable], dtype="<u4")
        conn.tail = buf[usable:]
        if len(words) == 0:
            return
        samples, resets, trailing_reset = transport.decode_stream(words)
        if log.isEnabledFor(logging.DEBUG):
            log.debug("slot %d rx %d words: %s%s", idx, len(words),
                      " ".join(f"{w:08x}" for w in words[:8]),
                      " ..." if len(words) > 8 else "")
        with slot.lock:
            slot.rx_words += len(words)
            before = slot.n_buffered
            # split at reset points so resets land on chunk starts; a
            # trailing reset word at the recv boundary becomes a zero-length
            # reset-first sentinel, preserving arrival order after
            # already-buffered samples (the reference host sends the reset
            # as its own 4-byte write, software/main.c mfcc_softreset)
            for s_arr, reset_first in transport.split_resets(
                    samples, resets, trailing_reset):
                slot.pending.append((s_arr, reset_first, t0))
                slot.n_buffered += len(s_arr)
            gatherable = ((before < self.chunk <= slot.n_buffered)
                          or bool(resets.any()) or trailing_reset)
        if self._spans is not None:
            self._spans.add("recv", t0, time.perf_counter_ns(), "reader",
                            slot=idx)
        if gatherable:
            # wake the stepper when this slot becomes gatherable (a full
            # chunk, or a reset that may bound a run), not on every recv: a
            # wake scans every slot, and a wake per recv costs O(slots^2) a
            # chunk period under load
            self._data.set()

    # -- control/status plane -------------------------------------------------

    def _handle_status_conn(self, handler):
        """One status-plane connection: newline-delimited commands, one JSON
        (or bare-word) reply line per command -- the register read/write
        semantics of the reference's Wishbone bridge
        (mfcc/io/ft601.py:214-330: a read command returns
        the register value, a write sets it), with the registers being the
        server's live observability state:

          PING              -> PONG                     (link probe)
          STATS             -> the threads' occupancy counters (stats())
          SLOTS             -> per-slot {active, rx_words, tx_frames,
                               buffered, in_flight}     (the RX/TX LEDs)
          TRACE             -> the span ring as a Chrome trace,
                               {"traceEvents": trace_events()} (empty
                               with trace_capacity 0)
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
                elif cmd == "TRACE":
                    reply = json.dumps({"traceEvents": self.trace_events()})
                elif cmd == "SLOTS":
                    reply = json.dumps([
                        {"active": s.conn is not None, "rx_words": s.rx_words,
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
        lengths, taken).  An EOF'd slot with a residual partial run is
        flushed as a zero-padded chunk with an explicit sample length.

        ``taken`` is (the chunks taken, their waits in their slots summed in
        ns, and with the span ring on their (slot, seq, whole ns, taken ns)
        in slot order, else None).  A chunk is whole at the recv that
        completed it, a flush run at the reset word or EOF that bounds
        it."""
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
        n_taken = wait_ns = 0
        taken = [] if self._spans is not None else None
        for i, slot in enumerate(self._slots):
            if slot.conn is None:     # racy-but-benign fast skip (GIL read;
                continue              # _alloc_slot confirms under the lock)
            with slot.lock:
                if slot.conn is None:
                    continue
                # a residual run is flushable once something bounds it: a
                # full chunk, client EOF, or a reset word that arrived AFTER
                # buffered samples (e.g. a file boundary -- the run's frames
                # must be emitted without waiting for more input)
                bounded = any(r and j > 0
                              for j, (_, r, _) in enumerate(slot.pending))
                if slot.n_buffered < C and not slot.eof and not bounded:
                    continue
                # A chunk holds samples of ONE reset epoch.  In hardware,
                # frames complete continuously as samples arrive, and a soft
                # reset drops only the in-flight partial window
                # (ResetInserter, mfcc.py:116).  Matching that: when a reset
                # word arrives mid-fill, the pre-reset run is FLUSHED as a
                # length-limited chunk (its completable frames are emitted),
                # and the reset epoch starts on the next gather.
                got = whole = 0
                reset_first = slot.reset_pending
                slot.reset_pending = False
                row = chunks[:, i] if self.transposed_chunks else chunks[i]
                while got < C and slot.pending:
                    s_arr, seg_reset, t_seg = slot.pending[0]
                    if seg_reset:
                        if got:           # flush the pre-reset run first
                            break
                        reset_first = True
                        slot.pending[0] = (s_arr, False, t_seg)
                        continue
                    take = min(C - got, len(s_arr))
                    row[got: got + take] = s_arr[:take]
                    got += take
                    whole = t_seg
                    if take == len(s_arr):
                        slot.pending.pop(0)
                    else:
                        slot.pending[0] = (s_arr[take:], False, t_seg)
                if got < C:
                    if got and (slot.pending or slot.eof):
                        # run bounded by a reset word (pending head) or by
                        # EOF: flush as a length-limited chunk (padding is
                        # masked out, carry keeps only real samples)
                        lengths[i] = got
                        whole = (slot.pending[0][2] if slot.pending
                                 else slot.eof_ns)
                    else:
                        # not enough data yet: put the run back intact
                        if got:
                            slot.pending.insert(
                                0, (row[:got].copy()
                                    .astype(chunks.dtype), False, whole))
                            row[:got] = 0
                        slot.reset_pending = reset_first
                        continue
                slot.n_buffered -= got
                resets[i] = reset_first
                active[i] = True
                slot.in_flight += 1
                seq = slot.seq
                slot.seq += 1
            now = time.perf_counter_ns()
            n_taken += 1
            wait_ns += now - whole
            if taken is not None:
                taken.append((i, seq, whole, now))
        return chunks, resets, active, lengths, (n_taken, wait_ns, taken)

    def _step_once(self) -> bool:
        """One stepper tick: gather + dispatch (async device work + async
        host copy begin), then hand the device handles to the delivery
        thread.  Up to ``pipeline_depth`` steps stay in flight: the device
        computes step k+2 while step k+1's results cross the wire and step
        k's frames are on the sockets.  The state chains step-to-step on
        the device, so the host never waits on it.  A slot's in_flight
        count holds from gather until ITS delivery.  The tick's gather,
        dispatch and blocked put are ``gather_s``, ``compute_s`` and
        ``backpressure_s``."""
        spans = self._spans
        t0 = time.perf_counter_ns()
        chunks, resets, active, lengths, (n, wait_ns, taken) = self._gather()
        t1 = time.perf_counter_ns()
        dispatched, step, sid = None, -1, 0
        if n:
            step = self._next_step
            self._next_step += 1
            if spans is not None:
                sid = spans.new_id()
            try:
                dispatched = self._dispatch(
                    chunks, resets, active, lengths,
                    None if spans is None else (step, sid))
            except Exception:
                log.exception("stepper: batched dispatch failed")
                self._clear_busy(active)
        t2 = time.perf_counter_ns()
        if dispatched is not None:
            item = (*dispatched, _Step(step, t2, taken))
            while not self._stop.is_set():     # blocking put = backpressure
                try:
                    self._outq.put(item, timeout=0.25)
                    break
                except queue.Full:
                    continue
        t3 = time.perf_counter_ns()
        st = self._stepper_counts
        st["gather_s"] += (t1 - t0) / 1e9
        st["compute_s"] += (t2 - t1) / 1e9
        st["backpressure_s"] += (t3 - t2) / 1e9
        st["chunks"] += n
        st["slot_wait_s"] += wait_ns / 1e9
        if dispatched is None:
            st["idle_ticks"] += 1
        if spans is not None:
            spans.add("gather", t0, t1, "stepper", step)
            if n:
                spans.add("dispatch", t1, t2, "stepper", step, sid=sid)
            if dispatched is not None:
                spans.add("backpressure", t2, t3, "stepper", step)
        return dispatched is not None

    def _run_delivery(self):
        """Delivery thread: blocking host readback + per-slot sends, fully
        overlapped with the stepper's gather/dispatch of later steps.  A
        step's time from its dispatch to this thread taking it is
        ``outq_wait_s``; its delivery is ``deliver_s``."""
        self._name_thread("delivery")
        cpu0 = time.thread_time()
        while True:
            try:
                item = self._outq.get(timeout=self._tick_s)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            t0 = time.perf_counter_ns()
            *args, step = item
            self._delivering = step
            try:
                self._deliver(*args)
            except Exception:
                log.exception("delivery: failed")
                self._clear_busy(args[2])
            t1 = time.perf_counter_ns()
            cpu1 = time.thread_time()
            st = self._delivery_counts
            st["deliver_s"] += (t1 - t0) / 1e9
            st["outq_wait_s"] += (t0 - step.t_put) / 1e9
            st["steps"] += 1
            st["delivery_cpu_s"] += cpu1 - cpu0
            cpu0 = cpu1
            if self._spans is not None:
                self._spans.add("outq_wait", step.t_put, t0, "outq", step.id)
            self._outq.task_done()

    def _clear_busy(self, active):
        for i in np.flatnonzero(active):
            slot = self._slots[i]
            with slot.lock:
                slot.in_flight -= 1
                conn = slot.conn if slot.eof and not slot.in_flight else None
            if conn is not None:          # an EOF'd slot's last delivery
                self._release_if_drained(conn)

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

    def _dispatch(self, chunks, resets, active, lengths, span=None):
        """Enqueue the batched step, the inactive-slot state rollback, the
        int16 wire conversion and the copies to the host on the device
        (asynchronously); returns (wire, mask, active, event), the event
        recorded after the copies (None on the CPU).  ``span``: (step id,
        id of the dispatch span) when the span ring is on, to record the
        three parts under it."""
        # all-full-chunk ticks (the steady serving state) take the fused
        # kernel; only ticks containing a flush (EOF / pre-reset run) pay
        # the length-masked chain step
        lens = None if (lengths == self.chunk).all() else lengths
        with self._device_ctx():
            if span is not None:
                t0 = time.perf_counter_ns()
            feats, mask, new_state = self._sm.step(chunks, self._state,
                                                   resets, lengths=lens)
            if span is not None:
                t1 = time.perf_counter_ns()
            # roll back the state of inactive slots (they were fed zeros);
            # each field is a fresh tensor, nothing is updated in place
            act = torch.as_tensor(active, device=self.device)
            self._state = StreamState(*(
                torch.where(act.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                for n, o in zip(new_state, self._state)))
            if span is not None:
                t2 = time.perf_counter_ns()
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
        if span is not None:
            t3 = time.perf_counter_ns()
            step, parent = span
            for name, a, b in (("dispatch.step", t0, t1),
                               ("dispatch.rollback", t1, t2),
                               ("dispatch.wire", t2, t3)):
                self._spans.add(name, a, b, "stepper", step, parent=parent)
        return wire, mask, active, event

    def _deliver(self, wire, mask, active, event):
        """Wait for a dispatched step's copies (its event), then the
        per-slot sends and the busy release: ``readback_wait_s``, then
        ``encode_s`` (the host view, the mask, ``encode_frames``, the
        counters) and ``send_s`` (the ``sendall``s) interleaved, slot by
        slot.  With the span ring on, each chunk's path ends at its send;
        the step is ``self._delivering``."""
        spans = self._spans
        step = self._delivering if spans is not None else None
        t0 = time.perf_counter_ns()
        if event is not None:
            event.synchronize()
        t1 = t = time.perf_counter_ns()
        wire, mask = wire.numpy(), mask.numpy()
        st = self._delivery_counts
        send_ns = k = 0
        for i, slot in enumerate(self._slots):
            if not active[i]:
                continue
            cols = wire[i][mask[i]]
            ts = te = None
            if len(cols):
                data = transport.encode_frames(cols)
                # count BEFORE the send: an observer who has received the
                # frames must see them counted
                st["frames_tx"] += len(cols)
                with slot.lock:
                    conn = slot.conn
                    slot.tx_frames += len(cols)
                if conn is not None:
                    ts = time.perf_counter_ns()
                    conn.send(data)
                    te = time.perf_counter_ns()
                    send_ns += te - ts
            if step is not None:
                t = self._chunk_spans(step, k, t, ts, te)
                k += 1
        t2 = time.perf_counter_ns()
        self._clear_busy(active)
        st["readback_wait_s"] += (t1 - t0) / 1e9
        st["encode_s"] += (t2 - t1 - send_ns) / 1e9
        st["send_s"] += send_ns / 1e9
        if step is not None:
            spans.add("readback_wait", t0, t1, "delivery", step.id)

    def _chunk_spans(self, step: _Step, k: int, t: int, ts, te) -> int:
        """Record the k-th chunk of ``step``: its wait in its slot, its
        encode from ``t`` and its send [ts, te] (None when nothing was
        sent), under one ``chunk`` span from whole to sent; returns where
        the next chunk's encode starts."""
        spans = self._spans
        slot, seq, whole, taken = step.chunks[k]
        end = te if te is not None else time.perf_counter_ns()
        cid = spans.new_id()
        spans.add("slot_wait", whole, taken, "chunk", step.id, slot, seq,
                  parent=cid)
        spans.add("encode", t, ts if ts is not None else end, "delivery",
                  step.id, slot, seq, parent=cid)
        if ts is not None:
            spans.add("send", ts, te, "delivery", step.id, slot, seq,
                      parent=cid)
        spans.add("chunk", whole, end, "chunk", step.id, slot, seq,
                  sid=cid)
        return end

    def _run_stepper(self):
        """Stepper thread: ticks, and between idle ticks the wait for a
        gatherable slot (``wait_s``)."""
        self._name_thread("stepper")
        cpu0 = time.thread_time()
        while not self._stop.is_set():
            try:
                self._data.clear()
                stepped = self._step_once()
            except Exception:
                # a failing tick must not kill the serving loop
                log.exception("stepper: tick failed")
                stepped = False
            waited = 0
            if not stepped:
                # wait for data instead of polling the slot scan; the
                # timeout bounds EOF-flush latency (a not-yet-ready slot
                # becomes flushable with no new bytes arriving)
                t0 = time.perf_counter_ns()
                self._data.wait(self._tick_s)
                t1 = time.perf_counter_ns()
                waited = t1 - t0
                if self._spans is not None:
                    self._spans.add("wait", t0, t1, "stepper")
            cpu1 = time.thread_time()
            st = self._stepper_counts
            st["wait_s"] += waited / 1e9
            st["stepper_cpu_s"] += cpu1 - cpu0
            cpu0 = cpu1

    def _name_thread(self, name: str) -> None:
        """Note the calling thread's native id under ``name`` (the span
        ring's thread tracks, the profiler's thread ids)."""
        if self._spans is not None:
            self._spans.threads[name] = threading.get_native_id()

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
            threading.Thread(target=self._run_stepper, daemon=True),
            threading.Thread(target=self._run_delivery, daemon=True),
            threading.Thread(target=self._run_reader, daemon=True),
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
            if self._status_tcp is not None:
                self._status_tcp.shutdown()
            for t in self._threads:
                t.join(10.0)
        self._unregister(self._listener)
        self._listener.close()
        if self._status_tcp is not None:
            self._status_tcp.server_close()
        for slot in self._slots:
            if slot.conn is not None:
                self._release_if_drained(slot.conn, force=True)
        self._sel.close()

    def activity(self):
        """Per-slot (rx_words, tx_frames) -- the RX/TX LED equivalent."""
        return [(s.rx_words, s.tx_frames) for s in self._slots]

    def stats(self):
        """The occupancy counters, a flat dict of numbers, each cumulative
        since the server was made and written by one thread only.

        Counts: ``steps`` (delivered), ``idle_ticks`` (stepper ticks that
        gathered nothing), ``frames_tx``, ``chunks`` (chunks and flush runs
        gathered), ``recvs``.  Wall seconds of the stepper, which together
        partition its time: ``gather_s``, ``compute_s`` (the dispatch),
        ``backpressure_s`` (blocked on a full queue of dispatched steps),
        ``wait_s`` (waiting for a gatherable slot).  Of the delivery:
        ``deliver_s``, which is ``readback_wait_s`` (the step's event) +
        ``encode_s`` + ``send_s`` + the release; ``outq_wait_s``, summed
        over delivered steps from dispatch to delivery.  Of the reader:
        ``reader_s`` (all but ``select``).  Of the chunks: ``slot_wait_s``,
        summed from whole in the slot to gathered.  CPU seconds of each
        thread: ``stepper_cpu_s``, ``delivery_cpu_s``, ``reader_cpu_s``
        (wall minus CPU in a phase is time waiting for the interpreter lock
        or in a system call)."""
        # each dict copied whole while the interpreter lock is held
        return {**self._stepper_counts, **self._delivery_counts,
                **self._reader_counts}

    def trace_events(self, base_ns: int = 0) -> list:
        """The span ring as Chrome-trace events: an ``"X"`` event a span,
        ``ts`` and ``dur`` in µs, ``ts`` on the epoch clock of
        ``torch.profiler``'s events less ``base_ns`` (pass a profiler
        export's ``baseTimeNanoseconds`` to share its timeline), ids in
        ``args``; the server's threads on their native ids beside the
        profiler's rows for them; the steps' waits in the queue on lanes
        that never overlap, each slot's chunks on a track of its own (a
        chunk overlaps the next when its reply took over a chunk period);
        each track named by an ``"M"`` event.  Empty with
        ``trace_capacity`` 0."""
        spans = self._spans
        if spans is None:
            return []
        recs = list(spans.records)        # one bytecode: no append between
        off = spans.offset_ns - base_ns
        pid = os.getpid()
        # a step waits from its dispatch to its delivery; the next
        # maxsize + 1 steps cannot all be waiting at once (FIFO)
        lanes = self._outq.maxsize + 1
        tracks = {}                        # tid -> track name
        events = []
        for sid, name, t0, t1, thread, step, slot, seq, parent in recs:
            if thread == "chunk":
                tid, track = _TRACKS + slot, f"chunks of slot {slot}"
            elif thread == "outq":
                lane = step % lanes
                tid, track = _TRACKS - 1 - lane, f"queue lane {lane}"
            else:
                tid, track = spans.threads.get(thread, 0), thread
            tracks[tid] = track
            args = {"id": sid}
            for key, v in (("step", step), ("slot", slot), ("seq", seq)):
                if v >= 0:
                    args[key] = v
            if parent:
                args["parent"] = parent
            events.append({"name": name, "cat": "server", "ph": "X",
                           "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3,
                           "pid": pid, "tid": tid, "args": args})
        return [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "args": {"name": f"FeatureServer {track}"}}
                for tid, track in sorted(tracks.items())] + events


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
