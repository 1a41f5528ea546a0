"""The load generator of the serving cells: N loopback TCP clients in a
process of their own that imports neither torch nor the program (numpy and
the standard library only), speaking the FPGA host protocol (uint32
little-endian sample words out, magic-framed big-endian int16 feature
columns back).

Open loop: client c's chunk k is due at t_load + phase_c + k * period,
whether or not earlier chunks were answered; the phases spread evenly over
a period and dealt to the clients in an order drawn from the seed.  The
load starts ``warm_s`` before the window (t0).
One sender thread sends every chunk at its due time; one selector thread
reads the replies.  A chunk's latency runs from its due time (never from
its send, so a stall on either side counts against every chunk it delays)
to the arrival of the last frame that the chunk completes: chunk k
completes frame count ((k + 1) * chunk - windowlen) // hop + 1.  How late
the sender ran is reported beside it.

Run as ``python -m perfbench.drivers.clients`` by the serve driver: one
JSON line of parameters on standard input, then "ready" on standard output;
"go <host> <port>" on standard input, then "start <t0>", "end <t1>" and
"blob <n>" followed by n bytes of an npz of the results.  t0 and t1 are
``time.perf_counter()`` readings, which share the system's monotonic clock
with the serving process.
"""

from __future__ import annotations

import gc
import heapq
import io
import json
import resource
import selectors
import socket
import sys
import threading
import time

import numpy as np

from perfbench.inputs import client_audio, subseed

MAGIC = 0xA55A


def words(samples: np.ndarray) -> bytes:
    """int16 samples -> uint32 little-endian sample words (int16 in the low
    half, no reset bit: the server resets a fresh connection)."""
    return (np.asarray(samples, np.int16).astype(np.uint16)
            .astype("<u4").tobytes())


def chunk_frames(k, chunk: int, windowlen: int, hop: int):
    """Frames a stream has once chunks 0..k have arrived."""
    n = (np.asarray(k) + 1) * chunk
    return np.where(n < windowlen, 0, (n - windowlen) // hop + 1)


def decode(data: bytes, ncep: int) -> tuple[np.ndarray, int]:
    """(F, ncep) int16 columns of whole magic-framed frames, and the number
    of frames whose magic word is wrong."""
    size = 2 * (ncep + 1)
    n = len(data) // size
    arr = np.frombuffer(data[: n * size], dtype=">u2").reshape(n, ncep + 1)
    return (arr[:, 1:].astype(np.uint16).view(np.int16).copy(),
            int((arr[:, 0] != MAGIC).sum()))


def raise_nofile() -> None:
    """Two descriptors a client: raise the soft limit to the hard one."""
    _, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    try:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ValueError, OSError):
        pass


class Load:
    """The clients of one run."""

    def __init__(self, p: dict):
        self.p = p
        n, C, R = p["clients"], p["chunk"], p["ring_chunks"]
        self.period = C / p["samplerate"]
        self.K = int(np.ceil((p["warm_s"] + p["seconds"]) / self.period)) + 1
        ring = [client_audio(p["seed"], c, R * C) for c in range(n)]
        self.payload = [[words(r[i * C:(i + 1) * C]) for i in range(R)]
                        for r in ring]
        # every seed the same arrivals, evenly spread over a period, in
        # another order over the clients
        rng = np.random.default_rng(subseed(p["seed"], "phases"))
        self.phase = rng.permutation((np.arange(n) + 0.5) / n * self.period)
        self.fsize = 2 * (p["ncep"] + 1)
        need = chunk_frames(np.arange(self.K), C, p["windowlen"], p["hop"])
        self.need = need.tolist()
        self.lat = np.full((n, self.K), np.nan)
        self.due_n = np.zeros(n, np.int64)      # chunks due in the window
        self.sent_n = np.zeros(n, np.int64)     # chunks whose words all left
        self.late = []
        self.rx = np.zeros(n, np.int64)         # bytes received
        self.rx_window = np.zeros(n, np.int64)  # bytes received in it
        self.next_k = [0] * n
        self.sample = set(p["sample"])
        self.kept = {c: bytearray() for c in self.sample}
        self.stop = threading.Event()

    def connect(self, host: str, port: int) -> float:
        t = time.perf_counter()
        self.socks = []
        for _ in range(self.p["clients"]):
            s = socket.create_connection((host, port))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.setblocking(False)
            self.socks.append(s)
        return time.perf_counter() - t

    def send_all(self) -> None:
        """The sender: every chunk at its due time, in order of due time,
        from ``t_load`` to the window's end; a send that would block is
        finished first at the client's next chunk (a chunk counts as sent
        once all its words have left)."""
        R = self.p["ring_chunks"]
        heap = [(self.t_load + ph, c, 0) for c, ph in enumerate(self.phase)]
        heapq.heapify(heap)
        backlog = [b""] * len(self.socks)
        queued = [[] for _ in self.socks]      # chunk ends in the backlog
        while heap:
            due, c, k = heapq.heappop(heap)
            if due >= self.t1:
                continue
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            data = backlog[c] + self.payload[c][k % R]
            try:
                n = self.socks[c].send(data)
            except (BlockingIOError, InterruptedError):
                n = 0
            self.late.append(time.perf_counter() - due)
            self.due_n[c] = k + 1
            queued[c].append(len(data))
            backlog[c] = data[n:]
            done = len(data) - len(backlog[c])
            while queued[c] and queued[c][0] <= done:
                queued[c].pop(0)
                self.sent_n[c] += 1
            heapq.heappush(heap, (due + self.period, c, k + 1))
        for c, rest in enumerate(backlog):      # finish what is left
            if rest:
                self.socks[c].setblocking(True)
                self.socks[c].sendall(rest)
                self.socks[c].setblocking(False)
                self.sent_n[c] = self.due_n[c]

    def read_all(self) -> None:
        """The reader: a chunk's latency is taken when the frame count that
        it completes has arrived."""
        sel = selectors.DefaultSelector()
        for c, s in enumerate(self.socks):
            sel.register(s, selectors.EVENT_READ, c)
        while not self.stop.is_set():
            for key, _ in sel.select(timeout=0.05):
                c = key.data
                try:
                    data = key.fileobj.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if not data:
                    sel.unregister(key.fileobj)
                    continue
                self.on_bytes(c, data, time.perf_counter())
        sel.close()

    def on_bytes(self, c: int, data: bytes, now: float) -> None:
        """Client ``c`` received ``data`` at ``now``: every chunk whose
        frames are now all in gets its latency from its due time."""
        self.rx[c] += len(data)
        if self.t0 <= now <= self.t1:
            self.rx_window[c] += len(data)
        if c in self.sample:
            self.kept[c] += data
        frames, k = self.rx[c] // self.fsize, self.next_k[c]
        while k < self.K and self.need[k] <= frames:
            self.lat[c, k] = now - (self.t_load + self.phase[c]
                                    + k * self.period)
            k += 1
        self.next_k[c] = k

    def answered(self) -> bool:
        return all(k >= d for k, d in zip(self.next_k, self.due_n))

    def close(self, timeout: float) -> None:
        """Shut every client's write side and read to the server's EOF."""
        for s in self.socks:
            try:
                s.shutdown(socket.SHUT_WR)
            except OSError:
                pass
        deadline = time.perf_counter() + timeout
        open_ = set(range(len(self.socks)))
        sel = selectors.DefaultSelector()
        for c in open_:
            sel.register(self.socks[c], selectors.EVENT_READ, c)
        while open_ and time.perf_counter() < deadline:
            for key, _ in sel.select(timeout=0.05):
                try:
                    data = key.fileobj.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if data:
                    self.rx[key.data] += len(data)
                    if key.data in self.sample:
                        self.kept[key.data] += data
                else:
                    sel.unregister(key.fileobj)
                    open_.discard(key.data)
        sel.close()
        for s in self.socks:
            s.close()

    def results(self, connect_s: float) -> bytes:
        ids = sorted(self.sample)
        kept = [np.frombuffer(bytes(self.kept[c]), np.uint8) for c in ids]
        buf = io.BytesIO()
        np.savez(buf, lat=self.lat, due_n=self.due_n, sent_n=self.sent_n,
                 late=np.asarray(self.late), rx=self.rx,
                 rx_window=self.rx_window, phase=self.phase,
                 sample=np.asarray(ids, np.int64),
                 kept=(np.concatenate(kept) if kept
                       else np.zeros(0, np.uint8)),
                 kept_len=np.asarray([len(k) for k in kept], np.int64),
                 t=np.asarray([self.t0, self.t1, connect_s]))
        return buf.getvalue()


def main() -> int:
    p = json.loads(sys.stdin.readline())
    raise_nofile()
    load = Load(p)
    # no collector pauses in the load generator's timing: what it keeps
    # holds no cycles
    gc.freeze()
    gc.disable()
    out = sys.stdout.buffer
    out.write(b"ready\n")
    out.flush()
    _, host, port = sys.stdin.readline().split()
    connect_s = load.connect(host, int(port))
    load.t_load = time.perf_counter() + p["lead_s"]
    t0 = load.t_load + p["warm_s"]
    load.t0, load.t1 = t0, t0 + p["seconds"]
    out.write(f"start {t0!r}\n".encode())
    out.flush()
    reader = threading.Thread(target=load.read_all)
    reader.start()
    load.send_all()
    while time.perf_counter() < load.t1:
        time.sleep(0.001)
    out.write(f"end {load.t1!r}\n".encode())
    out.flush()
    deadline = load.t1 + p["grace_s"]
    while not load.answered() and time.perf_counter() < deadline:
        time.sleep(0.01)
    load.stop.set()
    reader.join()
    load.close(p["grace_s"])
    blob = load.results(connect_s)
    out.write(f"blob {len(blob)}\n".encode())
    out.write(blob)
    out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
