"""End-to-end engine tests: generator -> loopback source -> demodulator ->
pipeline -> sink, covering the reference's --sw_loop measurement chain
(tx_single_link + software loopback + rx_single_link,
cpp/USRP_server_link_threads.cpp / cpp/USRP_hardware_manager.cpp)."""

import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.engine import (make_demodulator, make_generator,
                            plan_blocks, run_pipeline)
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource, LoopbackSource
from gpu_sdr.params import AntennaParams, AntMode, WaveType


def test_planner_commensurate():
    p = AntennaParams(mode=AntMode.RX, rate=1_000_000, decim=7,
                      buffer_len=100_000, samples=1_000_000,
                      freq=[1000], wave_type=[WaveType.DIRECT])
    plan = plan_blocks(p)
    assert plan.block_len % 7 == 0
    assert plan.out_rows == plan.block_len // 7
    assert plan.n_blocks * plan.block_len >= 1_000_000


def test_direct_loopback_tone_recovery():
    """TX a 3-tone comb, demodulate with DIRECT mode, check each channel
    lands at its amplitude at DC (config-3 style, tiny scale)."""
    rate = 1_000_000
    freqs = [100_000, -200_000, 333_333]
    ampls = [0.2, 0.3, 0.1]
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=100_000,
                       freq=freqs, ampl=ampls,
                       wave_type=[WaveType.TONES] * 3)
    rx = AntennaParams(mode=AntMode.RX, rate=rate, decim=100, pf_average=4,
                       buffer_len=100_000, samples=500_000,
                       freq=freqs, wave_type=[WaveType.DIRECT] * 3)
    demod = make_demodulator(rx)
    gen = make_generator(tx, block_len=demod.plan.block_len)
    sink = MemorySink()
    res = run_pipeline(demod, LoopbackSource(gen), [sink])
    data = sink.data           # (rows, 3)
    assert data.shape[1] == 3
    steady = data[8:, :]
    for c, a in enumerate(ampls):
        assert np.allclose(np.abs(steady[:, c]), a, atol=2e-3), \
            f"channel {c} amplitude off"
    assert res.rows == demod.plan.total_out_rows


def test_pfb_loopback_tone_recovery():
    """TX a comb on PFB bin centers, RX in TONES mode: each selected channel
    must carry its tone's power."""
    rate = 1_024_000
    nfft = 64
    bin_hz = rate // nfft
    freqs = [5 * bin_hz, -10 * bin_hz]
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=64_000,
                       freq=freqs, ampl=[0.5, 0.25],
                       wave_type=[WaveType.TONES] * 2)
    rx = AntennaParams(mode=AntMode.RX, rate=rate, fft_tones=nfft,
                       pf_average=4, buffer_len=64_000, samples=640_000,
                       freq=freqs, wave_type=[WaveType.TONES] * 2)
    demod = make_demodulator(rx)
    gen = make_generator(tx, block_len=demod.plan.block_len)
    sink = MemorySink()
    run_pipeline(demod, LoopbackSource(gen), [sink])
    data = sink.data[8:, :]    # skip transient
    # each channel: constant magnitude ~ amplitude (window normalized)
    m0 = np.abs(data[:, 0]).mean()
    m1 = np.abs(data[:, 1]).mean()
    assert 0.4 < m0 < 0.6, m0
    assert 0.2 < m1 < 0.3, m1
    # cross-talk well below signal
    assert np.abs(data[:, 0]).std() < 0.05 * m0


def test_chirp_vna_loopback_flat():
    """Full VNA chain through a loopback (ideal line): every lock-in point
    must be ~1+0j (flat S21)."""
    rate = 1_000_000
    p = dict(rate=rate, buffer_len=100_000,
             freq=[-400_000], chirp_f=[400_000], chirp_t=[0.1],
             swipe_s=[1000])
    tx = AntennaParams(mode=AntMode.TX, ampl=[1.0],
                       wave_type=[WaveType.CHIRP], **p)
    rx = AntennaParams(mode=AntMode.RX, decim=1, samples=200_000,
                       wave_type=[WaveType.CHIRP], **p)
    demod = make_demodulator(rx)
    gen = make_generator(tx, block_len=demod.plan.block_len)
    sink = MemorySink()
    run_pipeline(demod, LoopbackSource(gen), [sink])
    s21 = sink.data[:, 0]
    assert np.allclose(s21.real, 1.0, atol=1e-4)
    assert np.allclose(s21.imag, 0.0, atol=1e-4)


def test_nodsp_passthrough():
    rate = 1_000_000
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=50_000,
                       samples=100_000, wave_type=[WaveType.NODSP])
    demod = make_demodulator(rx)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(100_000) +
         1j * rng.standard_normal(100_000)).astype(np.complex64)
    sink = MemorySink()
    run_pipeline(demod, ArraySource(x), [sink])
    assert golden.snr_db(x, sink.data[:, 0]) > 120.0


def test_noise_full_spectrum_shape():
    rate = 1_024_000
    nfft = 128
    rx = AntennaParams(mode=AntMode.RX, rate=rate, fft_tones=nfft,
                       pf_average=4, buffer_len=128_000, samples=256_000,
                       freq=[0], wave_type=[WaveType.NOISE], decim=0)
    demod = make_demodulator(rx)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(demod.plan.total_samples) +
         1j * rng.standard_normal(demod.plan.total_samples)
         ).astype(np.complex64)
    sink = MemorySink()
    run_pipeline(demod, ArraySource(x), [sink])
    assert sink.data.shape[1] == nfft
    assert sink.data.shape[0] == demod.plan.total_out_rows
