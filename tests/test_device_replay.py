"""Device-resident replay (engine/replay.py) vs the host-fed path."""

import numpy as np
import pytest

from gpu_sdr.engine import make_demodulator, run_pipeline
from gpu_sdr import golden
from gpu_sdr.engine.replay import DeviceReplay, can_device_replay
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource, ReplaySource
from gpu_sdr.params import AntennaParams, AntMode, WaveType

RNG = np.random.default_rng(3)


def _rx(samples, buffer_len=20_000):
    return AntennaParams(mode=AntMode.RX, rate=1_000_000,
                         buffer_len=buffer_len, samples=samples,
                         decim=10, pf_average=4, freq=[100_000, -250_000],
                         wave_type=[WaveType.DIRECT] * 2)


def _rec(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
            ).astype(np.complex64)


@pytest.mark.parametrize("rec_len,loop", [
    (60_000, False),        # recording shorter than the acquisition
    (55_000, False),        # partial tail block + post-recording zeros
    (50_000, True),         # looped, block-commensurate (plan block 50k)
])
def test_device_replay_matches_host_fed(rec_len, loop):
    rx = _rx(samples=100_000)
    rec = _rec(rec_len)

    demod = make_demodulator(rx)
    sink_h = MemorySink()
    run_pipeline(demod, ArraySource(rec) if not loop else _LoopArray(rec),
                 [sink_h])

    dr = DeviceReplay(rx, rec, loop=loop)
    sink_d = MemorySink()
    dr.run([sink_d])

    a, b = sink_h.data, sink_d.data
    assert a.shape == b.shape
    assert np.array_equal(a, b), "device replay must bit-match host-fed"


class _LoopArray(ArraySource):
    """Host-fed looped recording (commensurate lengths only)."""

    def __init__(self, data):
        super().__init__(data)
        self.loop = True

    def blocks(self, block_len, n_blocks):
        assert len(self.data) % block_len == 0
        nb = len(self.data) // block_len
        for i in range(n_blocks):
            j = i % nb
            yield self.data[j * block_len:(j + 1) * block_len]


def test_run_measurement_dispatches_device_replay(tmp_path, monkeypatch):
    """run_measurement(source=ReplaySource) with a small recording takes
    the device-resident path and matches the host-fed result."""
    from gpu_sdr import measure as measure_mod
    from gpu_sdr.engine import replay as replay_mod
    from gpu_sdr.measure import run_measurement
    from gpu_sdr.params import UsrpParams

    monkeypatch.chdir(tmp_path)
    rec = _rec(60_000)
    np.save(tmp_path / "rec.npy", rec)
    src = ReplaySource(str(tmp_path / "rec.npy"))
    assert can_device_replay(src)

    cmd = UsrpParams()
    cmd.A_RX2 = _rx(samples=60_000)
    sink_d = MemorySink()
    calls = []
    orig = replay_mod.DeviceReplay.run

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(replay_mod.DeviceReplay, "run", spy)
    run_measurement(cmd, None, source=src, extra_sinks=[sink_d])
    assert calls, "device replay was not dispatched"

    # host-fed reference: force the budget to zero
    monkeypatch.setattr(replay_mod, "device_replay_max_bytes", lambda: 0)
    src2 = ReplaySource(str(tmp_path / "rec.npy"))
    assert not can_device_replay(src2)
    sink_h = MemorySink()
    run_measurement(cmd, None, source=src2, extra_sinks=[sink_h])
    assert np.array_equal(sink_d.data, sink_h.data)


def test_device_replay_kernel_path():
    """Looped commensurate DIRECT replay runs the resident scan, which
    bit-matches the host-fed path and agrees with the float64 oracle."""
    rx = _rx(samples=200_000, buffer_len=50_000)
    rec = _rec(100_000)                           # 2 blocks, looped
    dr = DeviceReplay(rx, rec, loop=True)
    assert dr.path == "scan"
    sink = MemorySink()
    dr.run([sink])
    demod = make_demodulator(rx)
    sink_h = MemorySink()
    run_pipeline(demod, _LoopArray(rec), [sink_h])
    assert np.array_equal(sink.data, sink_h.data)
    ref = golden.expected_stream(rx, np.resize(rec, 200_000))
    assert golden.snr_db(ref, sink.data) > 90.0


def test_budget_gate(monkeypatch):
    from gpu_sdr.engine import replay as replay_mod
    src = ArraySource(np.zeros(128, np.complex64))
    assert can_device_replay(src)
    # over budget -> host-fed path
    monkeypatch.setattr(replay_mod, "device_replay_max_bytes",
                        lambda: 128 * 8 - 1)
    assert not replay_mod.can_device_replay(src)
    # sources without a recording array -> host-fed path
    from gpu_sdr.engine.sources import WhiteNoiseSource
    assert not replay_mod.can_device_replay(WhiteNoiseSource())

    class NoData(ArraySource):
        @property
        def data(self):
            raise AttributeError("no data")

        def __init__(self):
            pass
    assert not replay_mod.can_device_replay(NoData())


@pytest.mark.parametrize("stats", [
    {"bytes_limit": 60_000, "bytes_in_use": 0},
    None,
])
def test_replay_budget_from_memory_stats(monkeypatch, stats):
    """The one-upload budget is a stated share of the device's memory
    limit; a backend reporting none (the CPU) gets the fixed host value."""
    from gpu_sdr.engine import replay as replay_mod

    class _Dev:
        def memory_stats(self):
            return stats

    monkeypatch.setattr(replay_mod.jax, "devices", lambda: [_Dev()])
    want = (replay_mod.HOST_REPLAY_MAX_BYTES if stats is None
            else int(60_000 * replay_mod.REPLAY_MEMORY_SHARE))
    assert replay_mod.device_replay_max_bytes() == want


def test_device_replay_lane_padded_matches_unpadded():
    """A 10-channel looped DIRECT recording replays at its own channel
    count and matches the oracle across the loop seam."""
    rate = 1_000_000
    freqs = [int(f) for f in np.linspace(-400_000, 400_000, 10)]
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=20_000,
                       samples=100_000, decim=10, pf_average=4,
                       freq=freqs, wave_type=[WaveType.DIRECT] * 10)
    rec = _rec(50_000)                 # looped: matches the 50k plan block
    dr = DeviceReplay(rx, rec, blocks_per_exec=2, loop=True)
    assert dr.path == "scan", dr.path
    sink = MemorySink()
    dr.run([sink])
    assert sink.data.shape == (100_000 // 10, 10)
    ref = golden.expected_stream(rx, np.resize(rec, 100_000))
    assert golden.snr_db(ref, sink.data) > 90.0


@pytest.mark.parametrize("wave", [WaveType.TONES, WaveType.NOISE])
def test_channelizer_replay_matches_host_fed(wave):
    """TONES (selected tones) and NOISE (full spectrum) replay of a
    looped recording: the resident scan matches the host-fed pipeline
    and the oracle across blocks and the loop seam."""
    rate, nfft = 1_000_000, 1000
    bin_hz = rate // nfft
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=128_000,
                       samples=256_000, fft_tones=nfft, pf_average=4,
                       freq=[50 * bin_hz, -200 * bin_hz],
                       wave_type=[wave] * (1 if wave == WaveType.NOISE
                                           else 2))
    rec = _rec(128_000)
    dr = DeviceReplay(rx, rec, blocks_per_exec=2, loop=True)
    assert dr.path == "scan", dr.path
    s_k = MemorySink()
    dr.run([s_k])

    demod = make_demodulator(rx)
    s_h = MemorySink()
    run_pipeline(demod, _LoopArray(rec), [s_h])
    assert np.array_equal(s_h.data, s_k.data)
    ref = golden.expected_stream(rx, np.resize(rec, 256_000))
    n = min(len(ref), len(s_k.data))
    assert golden.snr_db(ref[:n], s_k.data[:n]) > 85
