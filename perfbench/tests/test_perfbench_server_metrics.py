"""The readers of the serving cell's server counters: each number from a
made-up window of ``FeatureServer.stats()`` changes, and nothing (not an
error) where a server lacks the counter, as a server without them does."""

import pytest

from perfbench import harness

WINDOW = {"window_s": 20.0, "server_stats": {
    "steps": 2000, "chunks": 35000, "gather_s": 3.0, "compute_s": 2.0,
    "backpressure_s": 1.0, "wait_s": 14.0, "deliver_s": 11.6,
    "readback_wait_s": 0.4, "encode_s": 3.2, "send_s": 7.8,
    "outq_wait_s": 16.0, "reader_s": 1.5, "slot_wait_s": 70.0,
    "stepper_cpu_s": 4.0, "delivery_cpu_s": 9.0, "reader_cpu_s": 1.0}}
WANT = {"server.dispatch_share": 10.0, "server.backpressure_share": 5.0,
        "server.readback_wait_share": 2.0, "server.encode_share": 16.0,
        "server.send_share": 39.0, "server.reader_share": 7.5,
        "server.cpu_share": 70.0, "server.slot_wait_ms": 2.0,
        "server.outq_wait_ms": 8.0, "server.active_per_step": 17.5}
# what a server without the new counters reports
OLD = {"steps": 2000, "idle_ticks": 3, "gather_s": 3.0, "compute_s": 2.0,
       "deliver_s": 11.6, "frames_tx": 140000}


@pytest.mark.parametrize("name", sorted(WANT))
def test_server_counter_readers(name):
    bench = harness.load_benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert entry["layer"] == "server" and entry["moves"] == "served_streams"
    assert entry["workloads"] == ["int.serve"]
    read = harness.load_reader(name)
    assert read(WINDOW) == pytest.approx(WANT[name])
    assert read({}) is None
    old = read({"window_s": 20.0, "server_stats": OLD})
    assert old is None or name == "server.dispatch_share"
