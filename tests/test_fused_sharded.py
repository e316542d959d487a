"""Sharded fused TONES->PFB->select loopback chain vs the golden stream.

The scan-inside-shard_map chain (parallel/fused_sharded.py) must reproduce
the unsharded golden PFB of the golden tone stream on a (time, channels)
mesh, through multiple executions (halo + phase carries crossing both the
scan and the execution boundary)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from gpu_sdr import golden
from gpu_sdr.ops import cplx
from gpu_sdr.params import AntennaParams, AntMode, WaveType
from gpu_sdr.parallel.fused_sharded import ShardedFusedLoopback


def _mesh(t, c):
    devs = np.array(jax.devices()[:t * c]).reshape(t, c)
    return Mesh(devs, ("time", "channels"))


def _params(rate, freqs, ampls, nfft, avg):
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=rate,
                       freq=list(freqs), ampl=list(ampls),
                       wave_type=[WaveType.TONES] * len(freqs))
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=rate,
                       freq=list(freqs), ampl=list(ampls),
                       wave_type=[WaveType.TONES] * len(freqs),
                       fft_tones=nfft, pf_average=avg)
    return tx, rx


def _golden_selected(freqs, ampls, rate, nfft, avg, bins, n_samples):
    x = golden.tone_block(list(freqs), list(ampls), rate, 0, n_samples)
    frames = golden.pfb_frames(x, nfft, avg)
    return frames[:, bins]


@pytest.mark.parametrize("freqs,label", [
    ((3000, -7000, 15000), "const"),     # bin-aligned -> wavetable TX
    ((3001, -7013), "matmul"),           # off-grid -> matmul TX + phase
])
def test_sharded_fused_matches_golden(freqs, label):
    rate, nfft, avg = 64_000, 64, 4
    ampls = tuple(0.5 for _ in freqs)
    T, Kc = 4, 2
    L = T * nfft * 8                     # 8 frames per time shard
    K, n_exec = 3, 2
    tx, rx = _params(rate, freqs, ampls, nfft, avg)
    mesh = _mesh(T, Kc)
    sf = ShardedFusedLoopback(tx, rx, mesh, blocks_per_exec=K, block_len=L)
    assert sf._const_tx == (label == "const")

    state = sf.init_state()
    outs = []
    for _ in range(n_exec):
        state, ys = sf.run_exec(state)
        y = cplx.to_np(ys)               # (K, L//nfft, n_tones)
        outs.append(y.reshape(-1, y.shape[-1]))
    out = np.concatenate(outs, axis=0)

    bins = golden.tone_bins(list(freqs), rate, nfft)
    ref = _golden_selected(freqs, ampls, rate, nfft, avg, bins,
                           n_exec * K * L)
    # zero-primed halo: our frame t corresponds to golden frame t-(avg-1)
    skip = avg - 1
    n = min(len(ref), len(out) - skip)
    snr = golden.snr_db(ref[:n], out[skip:skip + n])
    assert snr > 90.0, f"{label}: SNR {snr:.1f} dB"


def test_run_measurement_dispatches_sharded_fused(monkeypatch, tmp_path):
    """run_measurement(mesh=...) with a fusable TONES->TONES loopback must
    take the sharded fused fast path and produce the golden tone stream."""
    from gpu_sdr.engine.sinks import MemorySink
    from gpu_sdr.measure import run_measurement
    from gpu_sdr.params import UsrpParams
    from gpu_sdr.parallel import fused_sharded as fs

    calls = []
    orig = fs.ShardedFusedLoopback.run

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(fs.ShardedFusedLoopback, "run", spy)
    monkeypatch.chdir(tmp_path)

    rate, nfft, avg = 1_024_000, 64, 4
    bin_hz = rate // nfft
    freqs = [5 * bin_hz, -10 * bin_hz]
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=64_000, samples=256_000,
        freq=freqs, ampl=[0.4, 0.3], wave_type=[WaveType.TONES] * 2,
        delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=64_000, samples=256_000,
        freq=freqs, fft_tones=nfft, pf_average=avg,
        wave_type=[WaveType.TONES] * 2, delay=1.0)
    mesh = _mesh(4, 2)
    sink = MemorySink()
    run_measurement(cmd, None, extra_sinks=[sink], mesh=mesh)
    assert calls, "sharded fused path was not dispatched"
    out = sink.data
    bins = golden.tone_bins(freqs, rate, nfft)
    ref = _golden_selected(freqs, [0.4, 0.3], rate, nfft, avg, bins,
                           out.shape[0] * nfft + (avg - 1) * nfft)
    skip = avg - 1
    n = min(len(ref), len(out) - skip)
    assert golden.snr_db(ref[:n], out[skip:skip + n]) > 90


def test_sharded_fused_vna_matches_unsharded():
    """CHIRP->CHIRP sharded fused chain == the single-device FusedLoopback
    (same chirp, same lock-in segmentation, block boundaries crossing the
    chirp period)."""
    from gpu_sdr.engine.fused import FusedLoopback
    from gpu_sdr.engine.sinks import MemorySink
    from gpu_sdr.parallel.fused_sharded import ShardedFusedVNA

    rate = 1_000_000
    p = dict(rate=rate, buffer_len=100_000, samples=400_000,
             freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
             swipe_s=[1000], delay=1.0)
    tx = AntennaParams(mode=AntMode.TX, ampl=[0.8],
                       wave_type=[WaveType.CHIRP], **p)
    rx = AntennaParams(mode=AntMode.RX, decim=1,
                       wave_type=[WaveType.CHIRP], **p)

    ref_sink = MemorySink()
    FusedLoopback(tx, rx, blocks_per_exec=2).run([ref_sink])
    ref = ref_sink.data

    T = 4
    devs = np.array(jax.devices()[:T])
    mesh = Mesh(devs, ("time",))
    ppt = 100  # chirp length/steps * decim = (0.1*1e6/1000)*1 = 100
    L = T * ppt * 250
    sf = ShardedFusedVNA(tx, rx, mesh, blocks_per_exec=2, block_len=L)
    assert sf.ppt == ppt
    state = sf.init_state()
    outs = []
    for _ in range(2):
        state, ys = sf.run_exec(state)
        y = cplx.to_np(ys)
        outs.append(y.reshape(-1, 1))
    out = np.concatenate(outs, axis=0)
    n = min(len(ref), len(out))
    assert n > 0
    assert golden.snr_db(ref[:n], out[:n]) > 100


def test_run_measurement_dispatches_sharded_vna(monkeypatch, tmp_path):
    from gpu_sdr.engine.sinks import MemorySink
    from gpu_sdr.measure import run_measurement
    from gpu_sdr.params import UsrpParams
    from gpu_sdr.parallel import fused_sharded as fs

    calls = []
    orig = fs.ShardedFusedVNA.run_exec

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(fs.ShardedFusedVNA, "run_exec", spy)
    monkeypatch.chdir(tmp_path)

    rate = 1_000_000
    p = dict(rate=rate, buffer_len=100_000, samples=300_000,
             freq=[-200_000], chirp_f=[200_000], chirp_t=[0.05],
             swipe_s=[500], delay=1.0)
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(mode=AntMode.TX, ampl=[1.0],
                               wave_type=[WaveType.CHIRP], **p)
    cmd.A_RX2 = AntennaParams(mode=AntMode.RX, decim=1,
                              wave_type=[WaveType.CHIRP], **p)
    mesh = Mesh(np.array(jax.devices()[:4]), ("time",))
    sink = MemorySink()
    run_measurement(cmd, None, extra_sinks=[sink], mesh=mesh)
    assert calls, "sharded fused VNA path was not dispatched"
    out = sink.data
    # loopback VNA: z = |chirp|^2 = 1 at every lock-in point
    assert out.shape[1] == 1 and out.shape[0] > 0
    assert np.allclose(out, 1.0, atol=1e-4)


def test_sharded_fused_time_only_mesh():
    """A 1-D time mesh (no channel axis) must also work: selection is a
    plain local gather of the full spectrum."""
    rate, nfft, avg = 32_000, 32, 4
    freqs, ampls = (2000, -5000), (0.7, 0.3)
    T = 4
    devs = np.array(jax.devices()[:T])
    mesh = Mesh(devs, ("time",))
    L = T * nfft * 4
    tx, rx = _params(rate, freqs, ampls, nfft, avg)
    sf = ShardedFusedLoopback(tx, rx, mesh, blocks_per_exec=2, block_len=L)
    state = sf.init_state()
    state, ys = sf.run_exec(state)
    state, ys2 = sf.run_exec(state)
    out = np.concatenate([cplx.to_np(y).reshape(-1, len(freqs))
                          for y in (ys, ys2)], axis=0)
    bins = golden.tone_bins(list(freqs), rate, nfft)
    ref = _golden_selected(freqs, ampls, rate, nfft, avg, bins, 4 * L)
    skip = avg - 1
    n = min(len(ref), len(out) - skip)
    snr = golden.snr_db(ref[:n], out[skip:skip + n])
    assert snr > 90.0, f"SNR {snr:.1f} dB"


def test_sharded_fused_two_exec_carry_matches_golden():
    """K=2 blocks per execution over two executions: the halo carry
    crosses the execution boundary and the stream matches golden."""
    freqs, ampls = (3000, -7000, 15000), (0.5, 0.5, 0.5)
    rate, nfft, avg = 64_000, 64, 4
    T, Kc = 4, 2
    L = T * nfft * 8
    K, n_exec = 2, 2
    tx, rx = _params(rate, freqs, ampls, nfft, avg)
    sf = ShardedFusedLoopback(tx, rx, _mesh(T, Kc), blocks_per_exec=K,
                              block_len=L)
    state = sf.init_state()
    outs = []
    for _ in range(n_exec):
        state, ys = sf.run_exec(state)
        y = cplx.to_np(ys)
        outs.append(y.reshape(-1, y.shape[-1]))
    out = np.concatenate(outs, axis=0)
    bins = golden.tone_bins(list(freqs), rate, nfft)
    ref = _golden_selected(freqs, ampls, rate, nfft, avg, bins,
                           n_exec * K * L)
    skip = avg - 1
    n = min(len(ref), len(out) - skip)
    snr = golden.snr_db(ref[:n], out[skip:skip + n])
    assert snr > 90.0, f"sharded SNR {snr:.1f} dB"


def _direct_cmd(rate, freqs, ampls, decim, pfa, L, n_blocks):
    from gpu_sdr.params import UsrpParams
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=L, samples=n_blocks * L,
        freq=list(freqs), ampl=list(ampls),
        wave_type=[WaveType.TONES] * len(freqs), delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=L, samples=n_blocks * L,
        freq=list(freqs), decim=decim, pf_average=pfa,
        wave_type=[WaveType.DIRECT] * len(freqs), delay=1.0)
    return cmd


def _run_direct_on_mesh(cmd, mesh,
                        path=("A_RX2", "sharded_fused", "fold_chain")):
    """TONES->DIRECT under a mesh through run_measurement: the sharded
    fold chain when the tone list splits over the channel axis, else the
    host-fed pipeline through the sharded DDC."""
    from gpu_sdr import measure as measure_mod
    from gpu_sdr.engine.dispatch import plan_dispatch
    from gpu_sdr.engine.sinks import MemorySink
    from gpu_sdr.measure import run_measurement
    plan = [d.key() for d in plan_dispatch(cmd, mesh=mesh)]
    sink = MemorySink()
    run_measurement(cmd, None, extra_sinks=[sink], mesh=mesh)
    assert measure_mod.LAST_DISPATCH == plan == [path]
    return sink.data


def _direct_golden(cmd):
    tx = cmd.A_TXRX
    x = golden.tone_block(tx.freq, tx.ampl, tx.rate, 0, tx.samples)
    return golden.expected_stream(cmd.A_RX2, x)


def test_sharded_fused_direct_matches_golden():
    """TONES->DIRECT on a (time, channels) mesh (the sharded fold chain,
    zero collectives) matches the float64 oracle across blocks."""
    cmd = _direct_cmd(1_000_000, (12_345, -67_891, 300_001, -111_111),
                      (0.4, 0.3, 0.2, 0.1), 10, 4, 80_000, 4)
    out = _run_direct_on_mesh(cmd, _mesh(2, 4))
    ref = _direct_golden(cmd)
    assert out.shape == ref.shape
    snr = golden.snr_db(ref, out)
    assert snr > 90.0, f"SNR {snr:.1f} dB"


@pytest.mark.parametrize("time_sharded", [True, False])
def test_sharded_fused_direct_matches_single_device_chain(time_sharded):
    """The sharded fold chain agrees with the single-device fold chain
    to float32 tolerance, time-sharded or channel-sharded."""
    from gpu_sdr.engine.fused import FusedLoopback
    from gpu_sdr.engine.sinks import MemorySink
    cmd = _direct_cmd(1_000_000, (12_345, -67_891), (0.5, 0.25), 10, 4,
                      50_000, 3)
    out = _run_direct_on_mesh(
        cmd, _mesh(2, 2) if time_sharded else _mesh(1, 2))
    fl = FusedLoopback(cmd.A_TXRX, cmd.A_RX2, blocks_per_exec=3)
    assert fl.path == "fold_chain"
    sink = MemorySink()
    fl.run([sink])
    assert sink.data.shape == out.shape
    assert golden.snr_db(sink.data, out) > 90.0


def test_run_measurement_dispatches_sharded_direct(monkeypatch, tmp_path):
    """run_measurement(mesh=...) with TONES->DIRECT takes the sharded
    fold chain and produces a valid acquisition."""
    monkeypatch.chdir(tmp_path)
    cmd = _direct_cmd(1_000_000, (12_345, -67_891), (0.5, 0.5), 10, 4,
                      50_000, 4)
    out = _run_direct_on_mesh(cmd, _mesh(2, 2))
    assert out.shape == (20_000, 2)
    steady = out[8:]
    assert np.allclose(np.abs(steady), 0.5, atol=2e-3)


def test_sharded_fused_direct_lane_padded():
    """Three tones on a two-way channel axis: the sharded DDC pads the
    tone list with a dummy channel to split evenly and slices it off, so
    sinks get the 3 logical channels and the oracle's values."""
    cmd = _direct_cmd(1_000_000, (12_345, -67_891, 300_001),
                      (0.4, 0.3, 0.2), 10, 4, 50_000, 4)
    out = _run_direct_on_mesh(cmd, _mesh(2, 2),
                              ("A_RX2", "host_pipeline", None))
    ref = _direct_golden(cmd)
    assert out.shape == ref.shape == (20_000, 3)
    assert golden.snr_db(ref, out) > 90.0


def test_sharded_channelizer_wavetable_matches_golden():
    """A bin-quantized comb on a TIME-ONLY mesh: the per-shard presum +
    DFT + select chain with its ppermute halo ring matches the float64
    oracle with the zero-primed startup."""
    freqs, ampls = (3000, -7000, 15000), (0.5, 0.5, 0.5)
    rate, nfft, avg = 64_000, 64, 4
    T, Kc = 8, 1
    L = T * nfft * 8
    K, n_exec = 2, 2
    tx, rx = _params(rate, freqs, ampls, nfft, avg)
    sf = ShardedFusedLoopback(tx, rx, _mesh(T, Kc), blocks_per_exec=K,
                              block_len=L)
    assert sf.path == "pfb_scan", sf.path
    state = sf.init_state()
    outs = []
    for _ in range(n_exec):
        state, ys = sf.run_exec(state)
        y = cplx.to_np(ys)
        outs.append(y.reshape(-1, y.shape[-1]))
    out = np.concatenate(outs, axis=0)
    bins = golden.tone_bins(list(freqs), rate, nfft)
    ref = _golden_selected(freqs, ampls, rate, nfft, avg, bins,
                           n_exec * K * L)
    skip = avg - 1
    n = min(len(ref), len(out) - skip)
    snr = golden.snr_db(ref[:n], out[skip:skip + n])
    assert snr > 90.0, f"sharded time-only PFB: {snr:.1f} dB"


def test_sharded_vna_table_matches_sincos_and_golden():
    """The sharded VNA (per-shard chirp synth + lock-in, no collectives)
    matches the float64 oracle and the single-device loopback."""
    from gpu_sdr.engine.fused import FusedLoopback
    from gpu_sdr.engine.sinks import MemorySink
    from gpu_sdr.parallel.fused_sharded import ShardedFusedVNA
    rate = 1_000_000
    kw = dict(rate=rate, freq=[-300_000], chirp_f=[300_000],
              chirp_t=[0.128], swipe_s=[128])
    L = 64_000
    tx = AntennaParams(mode=AntMode.TX, buffer_len=L, samples=4 * L,
                       ampl=[0.7], wave_type=[WaveType.CHIRP], **kw)
    rx = AntennaParams(mode=AntMode.RX, buffer_len=L, samples=4 * L,
                       decim=1, wave_type=[WaveType.CHIRP], **kw)
    v = ShardedFusedVNA(tx, rx, _mesh(4, 2), blocks_per_exec=2,
                        block_len=L)
    assert v.path == "chirp_lockin", v.path
    st = v.init_state()
    o = []
    for _ in range(2):
        st, ys = v.run_exec(st)
        o.append(cplx.to_np(ys).reshape(-1, 1))
    out = np.concatenate(o)
    cp = golden.ChirpParameter(-300_000, 300_000, rate, 128, 0.128)
    x = golden.chirp_signal(cp, 0, 4 * L, scale=0.7)
    ref = golden.expected_stream(rx, x)
    assert out.shape == ref.shape
    assert golden.snr_db(ref, out) > 90

    ref_sink = MemorySink()
    fl = FusedLoopback(tx, rx, blocks_per_exec=2)
    fl.run([ref_sink])
    n = min(len(ref_sink.data), len(out))
    assert n > 0
    snr = golden.snr_db(ref_sink.data[:n], out[:n])
    assert snr > 100, f"sharded VNA vs single-device: {snr:.1f} dB"
