"""Mesh-dispatched replay (parallel/sharded_replay.py): a recording
uploaded once, time-sharded over the virtual 8-device mesh, demodulated
by the sharded chains — output parity vs the single-device paths for
every demod mode, loop-seam correctness, and the run_measurement(mesh=)
dispatch."""

import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.client import files as Ufiles
from gpu_sdr.engine import make_demodulator, run_pipeline
from gpu_sdr.engine.replay import DeviceReplay
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource
from gpu_sdr.measure import run_measurement
from gpu_sdr.parallel import make_mesh
from gpu_sdr.parallel.sharded_replay import ShardedDeviceReplay
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType

RNG = np.random.default_rng(77)


def _comb(n, rate, freqs, ampls):
    t = np.arange(n)
    x = sum(a * np.exp(2j * np.pi * f * t / rate)
            for f, a in zip(freqs, ampls))
    return x.astype(np.complex64)


def _single_host_output(rx, rec):
    demod = make_demodulator(rx)
    sink = MemorySink()
    run_pipeline(demod, ArraySource(rec), [sink])
    return sink.data


def _sharded_replay_output(rx, rec, mesh, loop=False):
    sr = ShardedDeviceReplay(rx, rec, mesh, loop=loop)
    sink = MemorySink()
    sr.run([sink])
    return sink.data


def _snr(ref, got):
    n = min(len(ref), len(got))
    return golden.snr_db(ref[:n], got[:n])


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_sharded_replay_direct_matches_host(mesh_shape):
    rate = 1_000_000
    freqs = [100_000, -200_000, 50_000, -350_000]
    rx = AntennaParams(mode=AntMode.RX, rate=rate, decim=100,
                      pf_average=4, buffer_len=100_000, samples=400_000,
                      freq=freqs, wave_type=[WaveType.DIRECT] * 4)
    rec = _comb(400_000, rate, freqs, [0.4, 0.25, 0.2, 0.1]) + \
        0.01 * RNG.standard_normal(400_000).astype(np.complex64)
    mesh = make_mesh(mesh_shape, ("time", "channels"))
    ref = _single_host_output(rx, rec)
    got = _sharded_replay_output(rx, rec, mesh)
    assert _snr(ref, got) > 80


def test_sharded_replay_tones_matches_host():
    rate = 1_024_000
    nfft = 64
    bin_hz = rate // nfft
    freqs = [5 * bin_hz, -10 * bin_hz]
    rx = AntennaParams(mode=AntMode.RX, rate=rate, fft_tones=nfft,
                      pf_average=4, buffer_len=64_000, samples=256_000,
                      freq=freqs, wave_type=[WaveType.TONES] * 2)
    rec = _comb(256_000, rate, freqs, [0.5, 0.25])
    mesh = make_mesh((2, 4), ("time", "channels"))
    ref = _single_host_output(rx, rec)
    got = _sharded_replay_output(rx, rec, mesh)
    assert _snr(ref, got) > 80


def test_sharded_replay_noise_matches_host():
    rate = 1_024_000
    nfft = 64
    rx = AntennaParams(mode=AntMode.RX, rate=rate, fft_tones=nfft,
                      pf_average=4, buffer_len=64_000, samples=256_000,
                      freq=[0], wave_type=[WaveType.NOISE])
    rec = (RNG.standard_normal(256_000) +
           1j * RNG.standard_normal(256_000)).astype(np.complex64)
    mesh = make_mesh((2, 4), ("time", "channels"))
    ref = _single_host_output(rx, rec)
    got = _sharded_replay_output(rx, rec, mesh)
    assert got.shape[1] == nfft
    assert _snr(ref, got) > 80


def test_sharded_replay_chirp_matches_host():
    rate = 1_000_000
    rx = AntennaParams(mode=AntMode.RX, rate=rate, decim=1,
                      buffer_len=100_000, samples=400_000,
                      freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
                      swipe_s=[1000], wave_type=[WaveType.CHIRP])
    rec = (RNG.standard_normal(400_000) +
           1j * RNG.standard_normal(400_000)).astype(np.complex64)
    mesh = make_mesh((4, 2), ("time", "channels"))
    ref = _single_host_output(rx, rec)
    got = _sharded_replay_output(rx, rec, mesh)
    assert _snr(ref, got) > 80


def test_sharded_replay_loop_seam_matches_device_replay():
    """Looping a short recording: the sharded replay's wraparound must
    match the single-chip DeviceReplay block for block."""
    rate = 1_000_000
    freqs = [50_000, -150_000]
    rx = AntennaParams(mode=AntMode.RX, rate=rate, decim=100,
                      pf_average=4, buffer_len=100_000, samples=500_000,
                      freq=freqs, wave_type=[WaveType.DIRECT] * 2)
    mesh = make_mesh((4, 2), ("time", "channels"))
    blk = ShardedDeviceReplay(rx, np.zeros(100_000, np.complex64),
                              mesh, loop=True).demod.plan.block_len
    rec = _comb(2 * blk, rate, freqs, [0.5, 0.3])  # 2 blocks, loop
    dr = DeviceReplay(rx, rec, loop=True)
    s1 = MemorySink()
    dr.run([s1])
    got = _sharded_replay_output(rx, rec, mesh, loop=True)
    assert _snr(s1.data, got) > 80
    assert len(got) == len(s1.data)


def test_run_measurement_mesh_replay_dispatch(tmp_path, monkeypatch):
    """run_measurement(source=recording, mesh=...) takes the sharded
    replay path and writes the reference H5 layout."""
    monkeypatch.chdir(tmp_path)
    rate = 1_000_000
    freqs = [100_000]
    p = UsrpParams()
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=rate, decim=100,
                            pf_average=4, buffer_len=100_000,
                            samples=400_000, freq=freqs,
                            wave_type=[WaveType.DIRECT])
    rec = _comb(400_000, rate, freqs, [0.4])
    mesh = make_mesh((8, 1), ("time", "channels"))
    fn = run_measurement(p, filename="mesh_replay",
                         source=ArraySource(rec), mesh=mesh)
    data = Ufiles.openH5file(fn)
    assert data.shape == (1, 4_000)
    assert np.allclose(np.abs(data[0, 16:]), 0.4, atol=2e-3)


def test_sharded_segmented_matches_host(monkeypatch):
    """Recordings larger than the HBM budget under a mesh take the
    sharded segment-refill path and match the host-fed pipeline across
    >= 3 segment boundaries."""
    from gpu_sdr import measure as measure_mod
    from gpu_sdr.engine import replay as replay_mod
    from gpu_sdr.engine.dispatch import plan_dispatch
    from gpu_sdr.parallel.sharded_replay import ShardedSegmentedReplay

    rate = 1_000_000
    freqs = [100_000, -200_000]
    rx = AntennaParams(mode=AntMode.RX, rate=rate, decim=100,
                      pf_average=4, buffer_len=100_000, samples=800_000,
                      freq=freqs, wave_type=[WaveType.DIRECT] * 2)
    rec = _comb(800_000, rate, freqs, [0.5, 0.3]) + \
        0.01 * RNG.standard_normal(800_000).astype(np.complex64)
    mesh = make_mesh((4, 2), ("time", "channels"))
    ref = _single_host_output(rx, rec)

    blk = 100_000   # sharded plan block for this config
    sr = ShardedSegmentedReplay(rx, rec, mesh, blocks_per_exec=1,
                                segment_bytes=2 * blk * 8)
    assert sr.seg_blocks == 2      # 4 segments over the 8-block stream
    sink = MemorySink()
    sr.run([sink])
    assert sink.data.shape == ref.shape
    assert _snr(ref, sink.data) > 80

    # dispatch: run_measurement routes here when the budget is exceeded
    monkeypatch.setattr(replay_mod, "device_replay_max_bytes",
                        lambda: 2 * blk * 8)
    cmd = UsrpParams()
    cmd.A_RX2 = rx
    src = ArraySource(rec)
    plan = plan_dispatch(cmd, source=src, mesh=mesh)
    sink2 = MemorySink()
    run_measurement(cmd, filename=None, source=src, mesh=mesh,
                    extra_sinks=[sink2])
    assert measure_mod.LAST_DISPATCH == [
        ("A_RX2", "sharded_segmented_replay", None)]
    assert [d.key() for d in plan] == measure_mod.LAST_DISPATCH
    # blocks_per_exec differs (8 vs 1): scan fusion shifts the last ulp
    assert _snr(sink.data, sink2.data) > 120


@pytest.mark.parametrize("wave", [WaveType.TONES, WaveType.NOISE])
def test_sharded_channelizer_replay_matches_host_fed(wave):
    """Sharded TONES/NOISE replay on a time-only mesh (sharded scan,
    ppermute halo ring) matches the host-fed pipeline for selected-tone
    AND full-spectrum replay, across blocks and the loop seam."""
    rate, nfft = 1_000_000, 1000
    bin_hz = rate // nfft
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=128_000,
                       samples=256_000, fft_tones=nfft, pf_average=4,
                       freq=[50 * bin_hz, -200 * bin_hz],
                       wave_type=[wave] * (1 if wave == WaveType.NOISE
                                           else 2))
    rec = (RNG.standard_normal(128_000) +
           1j * RNG.standard_normal(128_000)).astype(np.complex64)
    mesh = make_mesh((8, 1), ("time", "channels"))
    sr = ShardedDeviceReplay(rx, rec, mesh, blocks_per_exec=2, loop=True)
    assert sr.path == "scan", sr.path
    s_k = MemorySink()
    sr.run([s_k])

    class _Loop:
        def blocks(self, block_len, n_blocks):
            for i in range(n_blocks):
                s = (i * block_len) % len(rec)
                idx = (np.arange(block_len) + s) % len(rec)
                yield rec[idx]

    demod = make_demodulator(rx)
    s_h = MemorySink()
    run_pipeline(demod, _Loop(), [s_h])

    n = min(len(s_k.data), len(s_h.data))
    assert n > 0
    snr = golden.snr_db(s_h.data[:n], s_k.data[:n])
    assert snr > 85, f"sharded replay vs host-fed ({wave}): {snr:.1f} dB"


def test_sharded_channelizer_replay_decimated():
    """Frame averaging (decim) under the sharded replay matches the
    single-chip resident scan and the oracle."""
    rate, nfft = 1_000_000, 1000
    bin_hz = rate // nfft
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=128_000,
                       samples=512_000, fft_tones=nfft, pf_average=4,
                       decim=4, freq=[50 * bin_hz, -200 * bin_hz],
                       wave_type=[WaveType.TONES] * 2)
    rec = (RNG.standard_normal(256_000) +
           1j * RNG.standard_normal(256_000)).astype(np.complex64)
    mesh = make_mesh((8, 1), ("time", "channels"))
    sr = ShardedDeviceReplay(rx, rec, mesh, blocks_per_exec=2, loop=True)
    assert sr.path == "scan", sr.path
    s_k = MemorySink()
    sr.run([s_k])

    dr = DeviceReplay(rx, rec, blocks_per_exec=2, loop=True)
    assert dr.path == "scan", dr.path
    s_1 = MemorySink()
    dr.run([s_1])
    assert s_k.data.shape == s_1.data.shape
    snr = golden.snr_db(s_1.data, s_k.data)
    assert snr > 100, f"sharded vs single-chip decimated: {snr:.1f} dB"
    ref = golden.expected_stream(rx, np.resize(rec, 512_000))
    assert golden.snr_db(ref, s_k.data) > 85


def test_sharded_channelizer_replay_gate_falls_back():
    """A channel-sharded mesh (Kc > 1) and a non-looped recording both
    run the sharded scan."""
    rate, nfft = 1_000_000, 1000
    bin_hz = rate // nfft
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=128_000,
                       samples=256_000, fft_tones=nfft, pf_average=4,
                       freq=[50 * bin_hz],
                       wave_type=[WaveType.TONES])
    rec = (RNG.standard_normal(128_000) +
           1j * RNG.standard_normal(128_000)).astype(np.complex64)
    sr = ShardedDeviceReplay(rx, rec, make_mesh((4, 2),
                                                ("time", "channels")),
                             blocks_per_exec=2, loop=True)
    assert sr.path == "scan", sr.path
    sr2 = ShardedDeviceReplay(rx, rec, make_mesh((8, 1),
                                                 ("time", "channels")),
                              blocks_per_exec=2, loop=False)
    assert sr2.path == "scan", sr2.path


def test_sharded_replay_kernel_matches_single_chip():
    """Looped DIRECT replay on a time-only mesh (sharded scan, ppermute
    FIR history) matches the single-chip resident scan and the oracle
    across blocks and the loop seam."""
    rate = 1_000_000
    freqs = [100_000, -250_000]
    L = 128_000
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=L,
                       samples=4 * L, decim=100, pf_average=4,
                       freq=freqs, wave_type=[WaveType.DIRECT] * 2)
    rec = (RNG.standard_normal(2 * L) +
           1j * RNG.standard_normal(2 * L)).astype(np.complex64)
    mesh = make_mesh((8, 1), ("time", "channels"))
    sr = ShardedDeviceReplay(rx, rec, mesh, blocks_per_exec=2, loop=True)
    assert sr.path == "scan", sr.path
    s_k = MemorySink()
    sr.run([s_k])
    dr = DeviceReplay(rx, rec, blocks_per_exec=2, loop=True)
    assert dr.path == "scan", dr.path
    s_1 = MemorySink()
    dr.run([s_1])
    assert s_k.data.shape == s_1.data.shape
    snr = golden.snr_db(s_1.data, s_k.data)
    assert snr > 110, f"sharded vs single-chip replay: {snr:.1f} dB"
    ref = golden.expected_stream(rx, np.resize(rec, 4 * L))
    assert golden.snr_db(ref, s_k.data) > 90


def test_sharded_replay_kernel_many_channels_lane_padded():
    """A 12-channel looped DIRECT recording on a (4, 1) mesh keeps its
    12 channels and matches the host-fed pipeline."""
    rate = 1_000_000
    freqs = [int(f) for f in np.linspace(-400_000, 400_000, 12)]
    L = 128_000
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=L,
                       samples=4 * L, decim=100, pf_average=4,
                       freq=freqs, wave_type=[WaveType.DIRECT] * 12)
    rec = (RNG.standard_normal(2 * L) +
           1j * RNG.standard_normal(2 * L)).astype(np.complex64)
    mesh = make_mesh((4, 1), ("time", "channels"))
    sr = ShardedDeviceReplay(rx, rec, mesh, blocks_per_exec=2, loop=True)
    assert sr.path == "scan", sr.path
    s_k = MemorySink()
    sr.run([s_k])
    assert s_k.data.shape[1] == 12

    class _Loop:
        def blocks(self, block_len, n_blocks):
            for i in range(n_blocks):
                s = (i * block_len) % len(rec)
                idx = (np.arange(block_len) + s) % len(rec)
                yield rec[idx]

    demod = make_demodulator(rx)
    s_h = MemorySink()
    run_pipeline(demod, _Loop(), [s_h])
    n = min(len(s_k.data), len(s_h.data))
    snr = golden.snr_db(s_h.data[:n], s_k.data[:n])
    assert snr > 85, f"sharded replay vs host-fed: {snr:.1f} dB"
