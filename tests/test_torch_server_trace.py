"""``FeatureServer``'s counters and span ring on the CPU (``device="cpu"``):
every server thread's time split into its phases, each chunk counted and
timed from whole in its slot, the ring bounded and linked (a chunk to its
step, a step to its phases), the status plane's ``TRACE``, and the spans on
``torch.profiler``'s clock.  Also the operator surface that reads them:
``server_loadtest --trace-out`` and ``serve``'s status line.

Every socket call and every ``join`` has a timeout of at most 60 s, so no
test can hang the suite."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mfcc_tpu_torch import FeatureServer, MFCCConfig, cli
from mfcc_tpu_torch.examples import server_loadtest
from mfcc_tpu_torch.io import transport
from mfcc_tpu_torch.server import query_status

CFG = MFCCConfig()
C = 512
TIMEOUT = 60
KEYS = {"steps", "idle_ticks", "frames_tx", "chunks", "recvs", "gather_s",
        "compute_s", "backpressure_s", "wait_s", "deliver_s", "outq_wait_s",
        "readback_wait_s", "encode_s", "send_s", "reader_s", "slot_wait_s",
        "stepper_cpu_s", "delivery_cpu_s", "reader_cpu_s"}


def _paced_clients(srv, n: int, k: int, period: float, audio):
    """``n`` clients, each sending ``k`` whole chunks one every ``period``
    s, then EOF, each reading its frames until the server closes.  Returns
    the frames each received."""
    host, port = srv.address
    got, errors = [0] * n, []

    def client(i):
        try:
            sig = np.resize(np.roll(audio, 17 * i), k * C).astype(np.int16)
            words = transport.encode_stream(sig, reset_first=True
                                            ).astype("<u4").tobytes()
            step = 4 * C
            with socket.create_connection((host, port),
                                          timeout=TIMEOUT) as sock:
                sock.settimeout(TIMEOUT)
                for j in range(k):
                    sock.sendall(words[j * step: (j + 1) * step])
                    time.sleep(period)
                sock.shutdown(socket.SHUT_WR)
                buf = b""
                while True:
                    data = sock.recv(65536)
                    if not data:
                        break
                    buf += data
            got[i] = len(transport.decode_frames(buf, CFG.nceptrums)[0])
        except Exception as e:              # surface in the main thread
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errors, errors
    return got


def test_counters_split_every_thread(audio_int16):
    """The stepper's four parts cover its time; the delivery's three parts
    lie inside ``deliver_s``; every chunk the clients sent is counted once,
    with a wait in its slot of no less than 0."""
    n, k = 3, 10
    srv = FeatureServer(CFG, max_streams=n, chunk=C, device="cpu").start()
    try:
        t_a = time.perf_counter()
        st_a = srv.stats()
        frames = _paced_clients(srv, n, k, 0.1, audio_int16)
        st_b = srv.stats()
        t_b = time.perf_counter()
    finally:
        srv.stop()
    st = srv.stats()
    assert set(st) == KEYS
    assert all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in st.values())
    stepper = sum(st_b[key] - st_a[key] for key in
                  ("gather_s", "compute_s", "backpressure_s", "wait_s"))
    assert abs(stepper - (t_b - t_a)) <= 0.1 * (t_b - t_a), (stepper,
                                                            t_b - t_a)
    parts = st["readback_wait_s"] + st["encode_s"] + st["send_s"]
    assert min(st["readback_wait_s"], st["encode_s"], st["send_s"]) >= 0
    assert 0 < parts <= st["deliver_s"] * (1 + 1e-9)
    assert st["chunks"] == n * k
    assert st["frames_tx"] == sum(frames) == n * CFG.n_frames(k * C)
    assert st["slot_wait_s"] >= 0 and st["outq_wait_s"] >= 0
    assert st["recvs"] >= n and st["reader_s"] > 0
    assert st["steps"] >= k
    for key in ("stepper_cpu_s", "delivery_cpu_s", "reader_cpu_s"):
        assert st[key] > 0


def test_ring_off_records_nothing(audio_int16):
    srv = FeatureServer(CFG, max_streams=1, chunk=C, device="cpu",
                        status_port=0).start()
    try:
        _paced_clients(srv, 1, 2, 0.0, audio_int16)
        (trace,) = query_status(*srv.status_address, "TRACE",
                                timeout=TIMEOUT)
    finally:
        srv.stop()
    assert srv._spans is None
    assert srv.trace_events() == [] and trace == {"traceEvents": []}


def test_ring_stays_bounded(audio_int16):
    srv = FeatureServer(CFG, max_streams=2, chunk=C, device="cpu",
                        trace_capacity=40).start()
    try:
        _paced_clients(srv, 2, 6, 0.0, audio_int16)
    finally:
        srv.stop()
    assert len(srv._spans.records) == 40
    assert sum(e["ph"] == "X" for e in srv.trace_events()) == 40


def test_chunks_link_to_their_steps(audio_int16):
    """Each chunk span links to a step that has its gather, dispatch (and
    the dispatch's three parts), queue wait, readback wait and sends; its
    wait in the slot and its send are its children, under its (slot,
    seq); the status plane's ``TRACE`` returns the same events as JSON."""
    n, k = 3, 5
    srv = FeatureServer(CFG, max_streams=n, chunk=C, device="cpu",
                        status_port=0, trace_capacity=100_000).start()
    try:
        _paced_clients(srv, n, k, 0.02, audio_int16)
        (trace,) = query_status(*srv.status_address, "TRACE",
                                timeout=TIMEOUT)
    finally:
        srv.stop()
    events = srv.trace_events()
    assert isinstance(trace, dict) and trace["traceEvents"]
    assert {e["name"] for e in trace["traceEvents"]} <= {
        e["name"] for e in events}
    xs = [e for e in events if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["cat"] == "server" for e in xs)
    by_step = {}
    for e in xs:
        by_step.setdefault(e["args"].get("step"), set()).add(e["name"])
    chunks = [e for e in xs if e["name"] == "chunk"]
    assert len(chunks) == n * k == srv.stats()["chunks"]
    assert len({(e["args"]["slot"], e["args"]["seq"]) for e in chunks}) \
        == n * k
    children = {}
    for e in xs:
        if "parent" in e["args"]:
            children.setdefault(e["args"]["parent"], []).append(e)
    for c in chunks:
        assert {"gather", "dispatch", "dispatch.step", "dispatch.rollback",
                "dispatch.wire", "outq_wait", "readback_wait",
                "send"} <= by_step[c["args"]["step"]]
        kids = {e["name"]: e for e in children[c["args"]["id"]]}
        assert set(kids) == {"slot_wait", "encode", "send"}
        for e in kids.values():
            assert (e["args"]["slot"], e["args"]["seq"]) == (
                c["args"]["slot"], c["args"]["seq"])
            # ts at the epoch's magnitude keeps a quarter of a µs
            assert c["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= c["ts"] + c["dur"] + 1
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"FeatureServer stepper", "FeatureServer delivery",
            "FeatureServer reader"} <= names


def test_spans_share_the_profilers_clock(audio_int16):
    """A ``record_function`` opened inside the stepper's gather lands, on
    the profiler's timeline, inside the exported ``gather`` span (50 µs
    either side)."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch._C._profiler import _ExperimentalConfig

    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        srv = FeatureServer(CFG, max_streams=2, chunk=C, device="cpu",
                            trace_capacity=100_000)
        gather = srv._gather

        def probed():
            with record_function("probe.gather"):
                return gather()
        srv._gather = probed
        srv.start(warmup=False)
        try:
            _paced_clients(srv, 2, 4, 0.02, audio_int16)
        finally:
            srv.stop()
    probes = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3)
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe.gather")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in srv.trace_events()
                   if e["ph"] == "X" and e["name"] == "gather")
    assert probes and len(probes) == len(spans)
    for (p0, p1), (s0, s1) in zip(probes, spans):
        assert s0 - 50 <= p0 <= p1 <= s1 + 50, (p0 - s0, s1 - p1)
    assert torch is not None


def test_idle_gaps_name_the_covering_phases():
    """``idle_gaps`` on made-up events: the card's idle share of the load,
    its gaps longest first, and for each server thread the share of a gap
    that each of its phases covers, a dispatch by its parts."""
    M = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
          "args": {"name": f"FeatureServer {name}"}}
         for tid, name in ((11, "stepper"), (12, "delivery"),
                           (13, "reader"), (99, "chunks of slot 0"))]

    def x(name, tid, ts, dur, sid, **args):
        return {"ph": "X", "cat": "server", "name": name, "pid": 1,
                "tid": tid, "ts": ts, "dur": dur,
                "args": {"id": sid, **args}}
    spans = M + [x("dispatch", 11, 100, 50, 1, step=1),
                 x("dispatch.step", 11, 100, 15, 2, parent=1),
                 x("dispatch.wire", 11, 115, 35, 3, parent=1),
                 x("backpressure", 11, 150, 400, 4, step=1),
                 x("send", 12, 112, 6, 5, parent=9),
                 x("encode", 12, 118, 2, 6, parent=10),
                 x("send", 12, 120, 10, 7, parent=10),
                 x("chunk", 99, 0, 1000, 9),
                 x("chunk", 99, 0, 1000, 10)]
    device = [(0, 110), (140, 200), (500, 900)]
    idle, gaps = server_loadtest.idle_gaps(device, spans, 0, 1000, top=5)
    assert idle == pytest.approx((30 + 300 + 100) / 1000)
    assert [(a, d) for a, d, _ in gaps] == [(200, 300), (900, 100),
                                           (110, 30)]
    assert gaps[0][2] == {"stepper": [("backpressure", 1.0)]}
    assert gaps[1][2] == {}
    cover = gaps[2][2]
    assert cover["stepper"] == [("dispatch.wire", pytest.approx(25 / 30)),
                                ("dispatch.step", pytest.approx(5 / 30))]
    assert cover["delivery"] == [("send", pytest.approx(16 / 30)),
                                 ("encode", pytest.approx(2 / 30))]
    assert "reader" not in cover


def test_server_loadtest_trace_out(tmp_path, capsys):
    """``--trace-out`` writes the server's spans and the profiler's trace
    as one Chrome trace, and the spans alone."""
    assert server_loadtest.main(["--streams", "2", "--seconds", "1",
                                 "--backend", "cpu", "--trace-out",
                                 str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[4].startswith("stepper: ") and "backpressure" in out[4]
    assert out[5].startswith("delivery: deliver ") and "send" in out[5]
    assert out[6].startswith("reader: ") and "cpu: stepper" in out[6]
    assert out[7].startswith("trace: ")
    assert out[8] == "device: no device activity recorded"
    timeline = json.loads((tmp_path / "timeline.json").read_text())
    server = json.loads((tmp_path / "server.json").read_text())
    assert server["traceEvents"] and all(
        e in timeline["traceEvents"] for e in server["traceEvents"][:50])
    assert any(e.get("cat") != "server" for e in timeline["traceEvents"])
    assert {"chunk", "send", "gather"} <= {e["name"]
                                           for e in server["traceEvents"]}


def test_serve_status_line_splits_the_delivery():
    st = dict.fromkeys(KEYS, 0)
    st.update(steps=7, frames_tx=28, gather_s=1.0, compute_s=2.0,
              backpressure_s=0.25, deliver_s=3.0, readback_wait_s=0.5,
              encode_s=1.0, send_s=1.5)
    line = cli.status_line(st, [(10, 4), (0, 0)])
    assert line == ("slots_seen=1/2 steps=7 frames_tx=28 gather=1.0s "
                    "compute=2.0s backpressure=0.2s deliver=3.0s "
                    "(readback=0.5s encode=1.0s send=1.5s)")


def test_serve_spans_tool_reads_the_cell(tmp_path):
    """``tools/serve_spans --trace`` at a tiny size on the CPU: the
    serving cell's run with the ring on, each chunk's path, which adds up
    to its span, and the clock probes, which land inside their stamps."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "mfcc_tpu_torch.tools.serve_spans", "--seed",
         str(2**31 + 5), "--seconds", "3", "--device", "cpu", "--clients",
         "3", "--trace", "--out", str(tmp_path)], cwd=root,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["capacity"] > 0
    assert line["counts"]["chunks"] > 0 and "send_s" in line["shares"]
    path = line["path_window"]
    assert path["total"]["n"] > 0
    assert all(path[k]["p50"] >= -1e-3 for k in path if k != "total")
    clock = line["clock"]
    assert clock["probe_start_after_us"]["n"] == 40
    assert clock["probe_start_after_us"]["p50"] > -50
    assert clock["probe_end_before_us"]["p50"] > -50
    assert (tmp_path / f"summary_{2**31 + 5}.json").exists()
