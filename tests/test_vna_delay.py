"""End-to-end VNA + line-delay workflow tests against simulated channels:
the measurement functions compose commands like the reference client, run
the engine in-process, write reference-layout H5 files, and the analysis
recovers the simulated physics (flat line, resonator dip, line delay)."""

import os

import numpy as np
import pytest

from gpu_sdr.client import delay as Udelay
from gpu_sdr.client import files as Ufiles
from gpu_sdr.client import vna as Uvna
from gpu_sdr.engine.channel import (ChainChannel, DelayChannel,
                                    make_resonator_channel)


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_single_vna_flat_line(tmp_chdir):
    fn = Uvna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.1,
                         n_points=500, tx_gain=0, Rate=int(1e6), RF=10_000_000,
                         output_filename="vna_flat")
    assert os.path.exists(fn)
    Uvna.VNA_analysis(fn)
    assert Uvna.is_VNA_analyzed(fn)
    freq, s21 = Uvna.get_VNA_data(fn, calibrated=False)
    assert len(freq) == 500
    # frequency axis is RF-centered and spans the chirp
    assert abs(freq[0] - (10_000_000 - 400_000)) < 1
    assert freq[-1] > 10_000_000 + 399_000
    # ideal loopback -> S21 == 1 everywhere
    assert np.allclose(np.abs(s21), 1.0, atol=1e-3)
    # round-trip file parameters
    info = Ufiles.get_rx_info(fn)
    assert info.swipe_s == [500]
    assert info.decim == 1


def test_vna_resonator_dip_with_delay_calibration(tmp_chdir):
    """The full calibration workflow (reference scripts/get_VNA.py): the
    channel has a real group delay (the filter's causal shift), so first
    measure the line delay, register it with set_line_delay, then run the
    VNA — whose lock-in is now coherent — and find the simulated resonator
    at the right frequency and depth."""
    rate = int(1e6)
    # linewidth f0/Qr = 5 kHz: resolvable by both the channel model's
    # impulse-response truncation and the 1 kHz VNA point spacing
    f0, Qr, Qe = 100_000.0, 20.0, 40.0

    def fresh_channel():
        return make_resonator_channel(rate, [dict(f0=f0, Qr=Qr, Qe_re=Qe)],
                                      fft_len=1 << 12)

    # 1. line-delay calibration against the channel (group delay = 512 smp)
    fn_d = Udelay.measure_line_delay(rate, 0, "A", duration=0.5,
                                     output_filename="delay_for_vna",
                                     channel=fresh_channel())
    d = Udelay.analyze_line_delay(fn_d)
    assert abs(d - 512e-6) < 20e-6, d
    Udelay.set_line_delay(rate, d * 1e9)
    assert Uvna.LINE_DELAY["1"] == d * 1e9

    # 2. VNA with compensation applied automatically from LINE_DELAY
    fn = Uvna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.2,
                         n_points=800, tx_gain=0, Rate=rate, RF=0,
                         output_filename="vna_reso",
                         channel=fresh_channel())
    Uvna.VNA_analysis(fn)
    freq, s21 = Uvna.get_VNA_data(fn, calibrated=False)
    interior = slice(20, None)     # skip the filter startup transient
    a = np.abs(s21[interior])
    fi = freq[interior]
    dip_f = fi[np.argmin(a)]
    assert abs(dip_f - f0) < 5_000, f"dip at {dip_f}, expected {f0}"
    expected_depth = abs(1 - Qr / Qe)
    assert abs(a.min() - expected_depth) < 0.1
    # away from the resonator S21 ~= 1
    far = np.abs(fi - f0) > 100_000
    assert np.allclose(a[far], 1.0, atol=0.05)
    Udelay.LINE_DELAY.clear()


def test_line_delay_roundtrip(tmp_chdir):
    """Simulate a known line delay and recover it with the reference's
    beat-tone analysis within its 5 ns resolution grid."""
    rate = int(1e6)
    true_delay_samples = 40                      # 40 us at 1 Msps
    chan = DelayChannel(true_delay_samples)
    fn = Udelay.measure_line_delay(rate, 10_000_000, "A", duration=0.5,
                                   output_filename="delay_meas",
                                   channel=chan)
    d = Udelay.analyze_line_delay(fn)
    true_delay = true_delay_samples / rate
    # welch bin resolution limits precision; generous tolerance
    assert abs(d - true_delay) < 0.3 * true_delay, (d, true_delay)
    Udelay.write_delay_to_file(fn, d)
    rate_msps, delay_ns = Udelay.load_delay_from_file(fn)
    assert rate_msps == 1
    assert delay_ns == int(d * 1e9)
    assert Udelay.LINE_DELAY["1"] == delay_ns
    Udelay.LINE_DELAY.clear()   # don't leak calibration into other tests


def test_vna_iterations_average(tmp_chdir):
    fn = Uvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=250, tx_gain=0, Rate=int(1e6), RF=0,
                         Iterations=4, output_filename="vna_iter")
    Uvna.VNA_analysis(fn)
    freq, s21 = Uvna.get_VNA_data(fn, calibrated=False)
    assert len(freq) == 250
    assert np.allclose(np.abs(s21), 1.0, atol=1e-3)


def test_vna_calibration_attr(tmp_chdir):
    fn = Uvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=100, tx_gain=10, Rate=int(1e6), RF=0,
                         output_filename="vna_cal")
    Uvna.VNA_analysis(fn)
    freq, s21_cal = Uvna.get_VNA_data(fn, calibrated=True)
    _, s21_raw = Uvna.get_VNA_data(fn, calibrated=False)
    expected = Ufiles.USRP_calibration / (10 ** ((Ufiles.USRP_power + 10) / 20))
    assert np.allclose(s21_cal, s21_raw * expected)


def test_vna_undecimated_analysis(tmp_chdir):
    """decimation=False: raw samples average per sweep, then per
    frequency point (regression: the old path split the raw stream at
    the wrong stride, mixing frequency points, and its final per-point
    average was an identity).  A delay channel makes S21's phase vary
    with frequency, so stride-mixing would smear it — an ideal loopback
    (flat all-ones S21) cannot detect the bug."""
    d = 40
    fn = Uvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=250, tx_gain=0, Rate=int(1e6), RF=0,
                         decimation=False, channel=DelayChannel(d),
                         output_filename="vna_undecim")
    Uvna.VNA_analysis(fn)
    freq, s21 = Uvna.get_VNA_data(fn, calibrated=False)
    assert len(freq) == 250
    # skip the first points (the delayed sweep's warmup transient)
    assert np.allclose(np.abs(s21[5:]), 1.0, atol=2e-2)
    # phase ramp = -2*pi*f*d/rate across the band
    want = np.angle(np.exp(-2j * np.pi * freq[5:] * d / 1e6))
    got = np.angle(s21[5:])
    err = np.angle(np.exp(1j * (got - want)))
    assert np.abs(err).max() < 0.05, np.abs(err).max()


def test_vna_iterations_reach_the_file(tmp_chdir):
    """Iterations=4 must land 4*n_points rows in the H5 dataset
    (regression: the sink capped at one sweep, silently discarding
    every later iteration)."""
    fn = Uvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=250, tx_gain=0, Rate=int(1e6), RF=0,
                         Iterations=4, output_filename="vna_iter_rows")
    data = Ufiles.openH5file(fn)
    assert data.shape[1] == 4 * 250, data.shape


def test_replay_source_short_file_loops(tmp_path):
    """A looped recording shorter than one block wraps as many times as
    needed (regression: single-wrap copy crashed on short files)."""
    import numpy as np
    from gpu_sdr.engine.sources import ReplaySource
    rec = (np.arange(300) + 1j).astype(np.complex64)
    p = str(tmp_path / "short.npy")
    np.save(p, rec)
    src = ReplaySource(p, loop=True)
    blks = list(src.blocks(1000, 2))
    want = np.tile(rec, 7)[:2000]
    got = np.concatenate(blks)
    assert np.array_equal(got, want)
