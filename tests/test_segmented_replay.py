"""Chunked HBM-refill replay (engine/replay.SegmentedDeviceReplay):
recordings larger than the device budget keep the device-resident path
via double-buffered segment uploads, bit-matching the host-fed pipeline
across segment boundaries.

Reference analog: unbounded-duration streaming — the RX thread refills
1 Msample buffers forever (cpp/USRP_hardware_manager.cpp:1398-1611).
"""

import numpy as np
import pytest

from gpu_sdr.engine import make_demodulator, run_pipeline
from gpu_sdr.engine.replay import (SegmentedDeviceReplay,
                                   can_device_replay,
                                   can_segmented_replay)
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource
from gpu_sdr.params import AntennaParams, AntMode, WaveType

RNG = np.random.default_rng(7)
BLK = 50_000          # the planner's block for this antenna config


def _rx(samples):
    return AntennaParams(mode=AntMode.RX, rate=1_000_000,
                         buffer_len=20_000, samples=samples,
                         decim=10, pf_average=4, freq=[100_000, -250_000],
                         wave_type=[WaveType.DIRECT] * 2)


def _rec(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
            ).astype(np.complex64)


class _LoopArray(ArraySource):
    def __init__(self, data):
        super().__init__(data)
        self.loop = True

    def blocks(self, block_len, n_blocks):
        assert len(self.data) % block_len == 0
        nb = len(self.data) // block_len
        for i in range(n_blocks):
            j = i % nb
            yield self.data[j * block_len:(j + 1) * block_len]


@pytest.mark.parametrize("rec_blocks,loop,acq_blocks", [
    (16, False, 16),     # segment boundaries inside the recording
    (5, False, 16),      # tail zero-pad + post-recording zero segments
    (3, True, 16),       # looped: wrap point straddles segments
])
def test_segmented_matches_host_fed(rec_blocks, loop, acq_blocks):
    rx = _rx(samples=acq_blocks * BLK)
    rec = _rec(rec_blocks * BLK)

    demod = make_demodulator(rx)
    assert demod.plan.block_len == BLK
    sink_h = MemorySink()
    run_pipeline(demod, _LoopArray(rec) if loop else ArraySource(rec),
                 [sink_h])

    # segment_bytes forces seg_blocks = 2 (with K=2): the 16-block
    # acquisition crosses 7 segment boundaries, and the recording's
    # tail/wrap never aligns with them
    sr = SegmentedDeviceReplay(rx, rec, loop=loop, blocks_per_exec=2,
                               segment_bytes=2 * BLK * 8)
    assert sr.seg_blocks == 2
    sink_s = MemorySink()
    sr.run([sink_s])

    a, b = sink_h.data, sink_s.data
    assert a.shape == b.shape
    assert np.array_equal(a, b), \
        "segmented replay must bit-match the host-fed path"


def test_state_carries_across_segments():
    """The demodulated stream is continuous across a segment boundary:
    a pure tone's phase advances exactly (no restart transient)."""
    rx = _rx(samples=8 * BLK)
    rec = _rec(8 * BLK)
    one = SegmentedDeviceReplay(rx, rec, blocks_per_exec=2,
                                segment_bytes=8 * BLK * 8)   # 1 segment
    many = SegmentedDeviceReplay(rx, rec, blocks_per_exec=2,
                                 segment_bytes=2 * BLK * 8)  # 4 segments
    s1, s2 = MemorySink(), MemorySink()
    one.run([s1])
    many.run([s2])
    assert np.array_equal(s1.data, s2.data)


def test_dispatch_rule(monkeypatch, tmp_path):
    """run_measurement routes oversized recordings onto the segmented
    path (and small ones still onto DeviceReplay)."""
    from gpu_sdr import measure as measure_mod
    from gpu_sdr.engine import replay as replay_mod
    from gpu_sdr.measure import run_measurement
    from gpu_sdr.params import UsrpParams

    monkeypatch.chdir(tmp_path)
    rec = _rec(4 * BLK)
    src = ArraySource(rec)

    # budget below the recording size -> segmented
    monkeypatch.setattr(replay_mod, "device_replay_max_bytes",
                        lambda: 2 * BLK * 8)
    assert not can_device_replay(src)
    assert can_segmented_replay(src)

    cmd = UsrpParams()
    cmd.A_RX2 = _rx(samples=4 * BLK)
    sink = MemorySink()
    run_measurement(cmd, filename=None, source=src, extra_sinks=[sink])
    assert measure_mod.LAST_DISPATCH == [
        ("A_RX2", "segmented_replay", None)]

    # host-fed oracle for the same command
    demod = make_demodulator(cmd.antenna("A_RX2"))
    sink_h = MemorySink()
    run_pipeline(demod, ArraySource(rec), [sink_h])
    assert np.array_equal(sink.data, sink_h.data)
