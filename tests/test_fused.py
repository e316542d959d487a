"""Fused on-device loopback chain: must produce the same results as the
host-driven pipeline for every fusable mode pair."""

import numpy as np
import pytest

from gpu_sdr.engine import make_demodulator, make_generator, run_pipeline
from gpu_sdr.engine.fused import FusedLoopback, can_fuse
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import LoopbackSource
from gpu_sdr.params import AntennaParams, AntMode, WaveType


def _pair(wave_rx, rx_extra, n_tones=3, rate=1_000_000, samples=400_000):
    freqs = [int(f) for f in np.linspace(-300_000, 300_000, n_tones)]
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=100_000,
                       samples=samples, freq=freqs,
                       ampl=[1.0 / n_tones] * n_tones,
                       wave_type=[WaveType.TONES] * n_tones, delay=1.0)
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=100_000,
                       samples=samples, freq=freqs,
                       wave_type=[wave_rx] * n_tones, delay=1.0,
                       **rx_extra)
    return tx, rx


@pytest.mark.parametrize("wave_rx,rx_extra", [
    (WaveType.DIRECT, dict(decim=100, pf_average=4)),
    (WaveType.TONES, dict(fft_tones=50, pf_average=4)),
    (WaveType.NOISE, dict(fft_tones=50, pf_average=4)),
])
def test_fused_matches_host_pipeline(wave_rx, rx_extra):
    tx, rx = _pair(wave_rx, rx_extra)
    assert can_fuse(tx, rx)

    fused = FusedLoopback(tx, rx, blocks_per_exec=2)
    sink_f = MemorySink()
    res = fused.run([sink_f])

    demod = make_demodulator(rx)
    gen = make_generator(tx, block_len=demod.plan.block_len)
    sink_h = MemorySink()
    run_pipeline(demod, LoopbackSource(gen), [sink_h])

    a, b = sink_f.data, sink_h.data
    n = min(len(a), len(b))
    assert n > 0
    assert np.allclose(a[:n], b[:n], atol=1e-5), \
        f"fused vs host mismatch for {wave_rx}"


def test_fused_vna_chirp():
    rate = 1_000_000
    p = dict(rate=rate, buffer_len=100_000, samples=400_000,
             freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
             swipe_s=[1000], delay=1.0)
    tx = AntennaParams(mode=AntMode.TX, ampl=[1.0],
                       wave_type=[WaveType.CHIRP], **p)
    rx = AntennaParams(mode=AntMode.RX, decim=1,
                       wave_type=[WaveType.CHIRP], **p)
    assert can_fuse(tx, rx)
    fused = FusedLoopback(tx, rx, blocks_per_exec=2)
    sink = MemorySink()
    fused.run([sink])
    s21 = sink.data[:, 0]
    assert np.allclose(s21.real, 1.0, atol=1e-4)
    assert np.allclose(s21.imag, 0.0, atol=1e-4)


def test_fused_tones_direct_single_kernel_chain():
    """Off-grid (non-periodic) combs dispatch onto the closed-form
    TONES->DIRECT fold chain (ops/fold_chain.py) and match the host
    pipeline and the oracle."""
    from gpu_sdr import golden
    rate, n_tones = 1_000_000, 3
    freqs = [12_345, -67_891, 300_001]          # gcd 1 -> period == rate
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=100_000,
                       samples=400_000, freq=freqs,
                       ampl=[1.0 / n_tones] * n_tones,
                       wave_type=[WaveType.TONES] * n_tones, delay=1.0)
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=100_000,
                       samples=400_000, freq=freqs, decim=100,
                       pf_average=4,
                       wave_type=[WaveType.DIRECT] * n_tones, delay=1.0)
    fused = FusedLoopback(tx, rx, blocks_per_exec=2)
    assert fused.path == "fold_chain"
    assert fused._init_states()[1] == (), "chain path must be selected"
    sink_f = MemorySink()
    fused.run([sink_f])

    demod = make_demodulator(rx)
    gen = make_generator(tx, block_len=demod.plan.block_len)
    sink_h = MemorySink()
    run_pipeline(demod, LoopbackSource(gen), [sink_h])

    a, b = sink_f.data, sink_h.data
    n = min(len(a), len(b))
    assert n > 0
    assert golden.snr_db(b[:n], a[:n]) > 90.0
    x = golden.tone_block(freqs, [1.0 / n_tones] * n_tones, rate, 0,
                          400_000)
    assert golden.snr_db(golden.expected_stream(rx, x), a) > 90.0


def test_fused_chirp_wavetable_chain():
    """A period-commensurate CHIRP->CHIRP loopback runs the generic
    chirp synth + lock-in scan and matches the oracle."""
    from gpu_sdr import golden
    rate = 1_000_000
    # steps=64 over 0.128 s -> length=2000; decim=1 -> ppt=2000;
    # period = 128_000 = 2 blocks of L=64_000
    kw = dict(rate=rate, buffer_len=64_000, samples=512_000,
              freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
              swipe_s=[64], delay=1.0)
    tx = AntennaParams(mode=AntMode.TX, ampl=[0.7],
                       wave_type=[WaveType.CHIRP], **kw)
    rx = AntennaParams(mode=AntMode.RX, decim=1,
                       wave_type=[WaveType.CHIRP], **kw)
    fused = FusedLoopback(tx, rx, blocks_per_exec=2)
    assert fused.path == "generic_scan" and fused.gen is not None
    sink = MemorySink()
    fused.run([sink])
    cp = golden.ChirpParameter(-300_000, 300_000, rate, 64, 0.128)
    x = golden.chirp_signal(cp, 0, 512_000, scale=0.7)
    ref = golden.expected_stream(rx, x)
    assert sink.data.shape == ref.shape
    assert golden.snr_db(ref, sink.data) > 90.0


def test_fused_channelizer_chain_tones_and_noise():
    """Bin-quantized TONES->TONES / TONES->NOISE loopbacks run the
    generic synth + channelizer scan and match tone amplitudes and the
    golden spectra."""
    from gpu_sdr import golden
    rate = 1_000_000
    nfft = 1000
    bin_hz = rate // nfft
    freqs = [50 * bin_hz, -200 * bin_hz]
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=100_000,
                       freq=freqs, ampl=[0.5, 0.25],
                       wave_type=[WaveType.TONES] * 2)
    rx = AntennaParams(mode=AntMode.RX, rate=rate, fft_tones=nfft,
                       pf_average=4, buffer_len=100_000, samples=400_000,
                       freq=freqs, wave_type=[WaveType.TONES] * 2)
    fl = FusedLoopback(tx, rx)
    assert fl.path == "generic_scan"
    sink = MemorySink()
    fl.run([sink])
    data = sink.data
    assert data.shape[1] == 2
    steady = data[8:]
    assert np.allclose(np.abs(steady[:, 0]), 0.5, rtol=1e-2)
    assert np.allclose(np.abs(steady[:, 1]), 0.25, rtol=1e-2)
    x = golden.tone_block(freqs, [0.5, 0.25], rate, 0, 400_000)
    assert golden.snr_db(golden.expected_stream(rx, x), data) > 90.0

    # NOISE (full spectrum): tone bins carry the power, natural order
    rx_n = AntennaParams(mode=AntMode.RX, rate=rate, fft_tones=nfft,
                         pf_average=4, buffer_len=100_000, samples=200_000,
                         freq=[0], wave_type=[WaveType.NOISE])
    fl2 = FusedLoopback(tx, rx_n)
    sink2 = MemorySink()
    fl2.run([sink2])
    spec = sink2.data.reshape(-1, nfft)[8:]
    b0 = golden.tone_bins(freqs, rate, nfft)
    mags = np.abs(spec).mean(axis=0)
    quiet = np.delete(mags, b0)
    assert mags[b0[0]] > 50 * quiet.mean()
    assert mags[b0[1]] > 25 * quiet.mean()


def test_fused_fold_chain_state_donation():
    """The fold chain's state is donated to each execution; a second
    acquisition from the same FusedLoopback still starts from the
    chain's intact masters and reproduces the first exactly."""
    rate = 1_000_000
    freqs = [12_345, -67_891, 300_001]          # non-periodic comb
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=100_000,
                       samples=400_000, freq=freqs, ampl=[0.3, 0.3, 0.4],
                       wave_type=[WaveType.TONES] * 3, delay=1.0)
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=100_000,
                       samples=400_000, freq=freqs, decim=100,
                       pf_average=4,
                       wave_type=[WaveType.DIRECT] * 3, delay=1.0)
    fused = FusedLoopback(tx, rx, blocks_per_exec=2)
    assert fused.path == "fold_chain"
    s0, s1 = MemorySink(), MemorySink()
    fused.run([s0])
    fused.run([s1])
    assert s1.data.shape == s0.data.shape == (4000, 3)
    assert np.array_equal(s0.data, s1.data)
