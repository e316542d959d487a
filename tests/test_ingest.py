"""Host-fed ingest pipeline tests: the double-buffered HostFeed and the
native socket ingest receiver (the equivalents of the reference's UHD RX
thread + pinned-pool double buffering, cpp/USRP_hardware_manager.cpp:
1398-1611 and cpp/USRP_server_link_threads.cpp:604-702)."""

import socket
import threading
import time

import numpy as np
import pytest

from gpu_sdr.engine import make_demodulator, run_pipeline
from gpu_sdr.engine.ingest import HostFeed, SocketIngestSource
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource, Source
from gpu_sdr.params import AntennaParams, AntMode, WaveType
from gpu_sdr.server import native


def _rx_params(rate=1_000_000, samples=800_000, buffer_len=100_000):
    return AntennaParams(mode=AntMode.RX, rate=rate, decim=100,
                         pf_average=4, buffer_len=buffer_len,
                         samples=samples,
                         freq=[100_000, -200_000],
                         wave_type=[WaveType.DIRECT] * 2)


def _comb(n, rate):
    t = np.arange(n)
    x = (0.3 * np.exp(2j * np.pi * 100_000 * t / rate) +
         0.2 * np.exp(2j * np.pi * -200_000 * t / rate))
    return x.astype(np.complex64)


def test_hostfeed_bit_identical():
    """The pipelined feed must not change a single bit of the output."""
    rx = _rx_params()
    data = _comb(800_000, rx.rate)

    outs = []
    for fd in (0, 2):
        demod = make_demodulator(rx)
        sink = MemorySink()
        run_pipeline(demod, ArraySource(data), [sink], feed_depth=fd)
        outs.append(sink.data)
    np.testing.assert_array_equal(outs[0], outs[1])


class PacedSource(Source):
    """Blocks that take real wall time to produce, like a radio delivering
    at its sample rate: each block costs `pace` seconds on the feeder
    thread (sleep stands in for the radio's arrival time; the numpy
    conversion work is real)."""

    def __init__(self, data, pace):
        self.data = data
        self.pace = pace
        self.feed_time = 0.0

    def blocks(self, block_len, n_blocks):
        for i in range(n_blocks):
            t0 = time.perf_counter()
            time.sleep(self.pace)
            blk = np.asarray(self.data[i * block_len:(i + 1) * block_len],
                             dtype=np.complex64)
            self.feed_time += time.perf_counter() - t0
            yield blk


def test_hostfeed_overlaps_feed_and_compute():
    """The defining property of the double-buffered feed: wall time of the
    pipelined run < serial feed time + compute time."""
    rx = _rx_params(samples=1_600_000)
    data = _comb(1_600_000, rx.rate)
    demod = make_demodulator(rx)
    n_blocks = demod.plan.n_blocks
    # warm the jit cache so compile time doesn't pollute the timing
    run_pipeline(make_demodulator(rx), ArraySource(data), [MemorySink()])

    # compute-only time: pre-produced blocks, inline feed
    t0 = time.perf_counter()
    run_pipeline(make_demodulator(rx), ArraySource(data), [MemorySink()],
                 feed_depth=0)
    t_comp = time.perf_counter() - t0

    # pace each block at ~2x the measured compute time per block so the
    # feed clearly dominates: pipelined wall ~ feed time alone, serial
    # ~ 1.5x that.  Timing under load flakes, so take the best of four
    # attempts before judging.
    pace = max(0.05, 2.0 * t_comp / n_blocks)
    best_ratio = np.inf
    for _ in range(4):
        src = PacedSource(data, pace)
        sink = MemorySink()
        t0 = time.perf_counter()
        run_pipeline(make_demodulator(rx), src, [sink], feed_depth=2)
        wall = time.perf_counter() - t0
        assert src.feed_time > 0
        serial = src.feed_time + t_comp
        best_ratio = min(best_ratio, wall / serial)
        if best_ratio < 0.9:
            break
    assert best_ratio < 0.9, \
        (f"no overlap: wall/serial={best_ratio:.2f} "
         f"(feed={src.feed_time:.3f}s, compute={t_comp:.3f}s)")
    # and the output is still right
    np.testing.assert_allclose(np.abs(sink.data[8:, 0]), 0.3, atol=2e-3)


class BoomSource(Source):
    def blocks(self, block_len, n_blocks):
        yield np.zeros(block_len, np.complex64)
        raise RuntimeError("boom")


def test_hostfeed_propagates_source_errors():
    feed = HostFeed(BoomSource(), depth=2)
    it = feed.device_blocks(1000, 4)
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        for _ in it:
            pass


needs_native = pytest.mark.skipif(not native.ingest_available(),
                                  reason="native ingest library not built")


def _send_all(port, payload, chunk=65536):
    with socket.create_connection(("127.0.0.1", port)) as s:
        view = memoryview(payload)
        for i in range(0, len(view), chunk):
            s.sendall(view[i:i + chunk])


@needs_native
def test_socket_ingest_matches_array_source():
    """A producer streaming complex64 over TCP must demodulate identically
    to the same samples served from memory."""
    rx = _rx_params()
    data = _comb(800_000, rx.rate)

    demod = make_demodulator(rx)
    ref_sink = MemorySink()
    run_pipeline(demod, ArraySource(data), [ref_sink])

    with SocketIngestSource(block_len=demod.plan.block_len,
                            timeout=30.0) as src:
        producer = threading.Thread(
            target=_send_all, args=(src.port, data.tobytes()), daemon=True)
        producer.start()
        sink = MemorySink()
        run_pipeline(make_demodulator(rx), src, [sink])
        producer.join(timeout=10)
        stats = src.stats
    np.testing.assert_array_equal(ref_sink.data, sink.data)
    assert stats["blocks_received"] == demod.plan.n_blocks
    assert stats["overflows"] == 0


@needs_native
def test_socket_ingest_producer_hangup_ends_short():
    """Producer dies mid-measurement: the stream ends SHORT — the padded
    tail block is error-stamped and no further blocks are fabricated
    (the reference declares "USRP is not streaming" and aborts,
    cpp/USRP_hardware_manager.cpp:1546-1560)."""
    rx = _rx_params()
    demod = make_demodulator(rx)
    plan = demod.plan
    blk = plan.block_len
    data = _comb(blk + blk // 2, rx.rate)   # 1.5 blocks then EOF

    with SocketIngestSource(block_len=blk, timeout=30.0) as src:
        producer = threading.Thread(
            target=_send_all, args=(src.port, data.tobytes()), daemon=True)
        producer.start()
        sink = MemorySink()
        res = run_pipeline(make_demodulator(rx), src, [sink])
        producer.join(timeout=10)
        assert src.aborted
        assert src.shortfall_blocks == plan.n_blocks - 2
        assert src.stats["padded"] == blk - blk // 2
    # only the two delivered blocks were emitted, nothing fabricated after
    assert res.n_blocks == 2
    rows_per_block = plan.block_len // rx.decim
    assert sink.data.shape[0] == 2 * rows_per_block
    # the first block demodulated the comb for real
    assert np.abs(sink.data[2]).max() > 0.1
    # the zero-padded tail samples are error-stamped on a delivered
    # packet (which one depends on when the feeder samples the counter —
    # the native thread may hit EOF before block 0 drains)
    assert sum(m.errors for m in sink.metas) > 0


@needs_native
def test_ingest_abort_writes_short_flagged_h5(tmp_path, monkeypatch):
    """Kill the producer mid-measurement through the full measurement
    path: the H5 file must come out SHORT (dataset shrunk to what was
    delivered), with nonzero `errors` entries and the group flagged
    aborted — never silent zero rows."""
    import h5py

    from gpu_sdr.measure import run_measurement
    from gpu_sdr.params import UsrpParams

    monkeypatch.chdir(tmp_path)
    rx = _rx_params()
    params = UsrpParams()
    params.A_RX2 = rx
    demod = make_demodulator(rx)
    plan = demod.plan
    blk = plan.block_len
    data = _comb(blk + blk // 2, rx.rate)   # 1.5 blocks then EOF

    with SocketIngestSource(block_len=blk, timeout=30.0) as src:
        producer = threading.Thread(
            target=_send_all, args=(src.port, data.tobytes()), daemon=True)
        producer.start()
        fn = run_measurement(params, "aborted_meas", source=src)
        producer.join(timeout=10)
        assert src.aborted

    rows_per_block = blk // rx.decim
    with h5py.File(fn, "r") as f:
        g = f["raw_data0"]["A_RX2"]
        # short: shrunk to the two delivered blocks, not samples/decim
        assert g["data"].shape == (2, 2 * rows_per_block)
        assert g["data"].attrs["samples"] == 2 * rows_per_block
        # flagged
        assert bool(g.attrs["aborted"])
        assert int(g.attrs["shortfall_blocks"]) == plan.n_blocks - 2
        # the zero-padded tail samples are error-stamped inside the
        # delivered region
        errs = g["errors"][:]
        assert errs.shape[0] >= 1
        assert 0 < errs[-1][1] <= 2 * rows_per_block


@needs_native
def test_socket_ingest_overflow_counts_as_errors():
    """When the consumer falls behind the wire the native ring drops blocks
    and counts them like UHD overflows."""
    blk = 50_000
    data = np.zeros(blk * 8, np.complex64)
    with SocketIngestSource(block_len=blk, queue_len=3,
                            timeout=30.0) as src:
        _send_all(src.port, data.tobytes())
        # producer pushed 8 blocks into a 3-deep ring with nobody draining:
        # some must have been dropped
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            st = src.stats
            if st["blocks_received"] + st["overflows"] >= 8:
                break
            time.sleep(0.01)
        st = src.stats
        assert st["overflows"] > 0
        assert st["blocks_received"] + st["overflows"] == 8
        assert src.take_errors() == st["overflows"]
        assert src.take_errors() == 0   # delta semantics
