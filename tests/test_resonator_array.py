"""Closed-loop science at reference scale: a 50-resonator array.

The reference exists for frequency-multiplexed MKID arrays: its fitter is
an iterative multi-peak machine (pyUSRP/USRP_fitting.py:380-586
initialize_peaks) and its stress config loads 1000 channels
(scripts/network_test.py).  This drives the full workflow on a
50-resonator simulated array — wide VNA -> extimate_peak_number ->
initialize_peaks -> vna_fit -> get_tones -> multi-tone DIRECT noise
readout at the fitted tones — and asserts peak-count recovery,
per-resonator f0/Qr error statistics, and the noise PSDs at the fitted
tones.
"""

import numpy as np
import pytest

from gpu_sdr.client import delay as Udelay
from gpu_sdr.client import files as Ufiles
from gpu_sdr.client import fitting as Ufit
from gpu_sdr.client import noise as Unoise
from gpu_sdr.client import vna as Uvna
from gpu_sdr.engine.channel import make_resonator_channel

N_RESO = 50
RATE = int(4e6)
RF = 10_000_000


def make_array(seed=7):
    """50 resonators in two bands clear of the carrier (+-0.12..1.6 MHz
    baseband), ~59 kHz pitch with jitter (min gap ~49 kHz), linewidth
    f0/Qr ~= 8-12 kHz, dip depth ~6 dB."""
    rng = np.random.default_rng(seed)
    slots = np.concatenate([np.linspace(-1.6e6, -0.12e6, N_RESO // 2),
                            np.linspace(0.12e6, 1.6e6, N_RESO // 2)])
    f0s = slots + rng.uniform(-5e3, 5e3, N_RESO)
    resos = []
    for f0 in sorted(f0s):
        # SIGNED Qr: resonator_s21's detuning is y = (f-f0)/f0*Qr, so a
        # negative baseband f0 with positive Qr would MIRROR the
        # resonance asymmetry relative to a physical absolute-frequency
        # resonator (the fitter then absorbs the mirror into a spurious
        # bifurcation 'a' and a wrong Qr).  Signing Qr with f0 restores
        # the physical line shape; the absolute quality factor is
        # Qr * (RF + f0) / f0 > 0.
        Qr = f0 / rng.uniform(8e3, 12e3)
        resos.append(dict(f0=float(f0), Qr=float(Qr),
                          Qe_re=float(2.0 * Qr)))
    return resos


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_fifty_resonator_closed_loop(tmp_chdir):
    resos = make_array()
    chan = make_resonator_channel(RATE, resos, fft_len=1 << 14)
    Udelay.set_line_delay(RATE, 512e-6 * 1e9)
    try:
        fn = Uvna.Single_VNA(start_f=-1_800_000, last_f=1_800_000,
                             measure_t=0.45, n_points=3600, tx_gain=0,
                             Rate=RATE, RF=RF,
                             output_filename="vna_array", channel=chan)
        Uvna.VNA_analysis(fn)
    finally:
        Udelay.LINE_DELAY.clear()

    # 1) peak-count estimation (gradient estimator): within 10% of truth
    n_est = Ufit.extimate_peak_number(fn, threshold=0.1, peak_width=30e3,
                                      exclude_center=False)
    assert abs(n_est - N_RESO) <= 5, f"estimated {n_est} of {N_RESO}"

    # 2) iterative fit-and-filter init finds every resonator
    ok = Ufit.initialize_peaks(fn, N_peaks=N_RESO, peak_width=30e3,
                               Qr_cutoff=3, Mag_depth_cutoff=0.5,
                               exclude_center=False)
    inits = Ufiles.get_init_peaks(fn)
    assert ok and len(inits) == N_RESO, f"init found {len(inits)}"

    # 3) per-resonator nonlinear fits
    assert Ufit.vna_fit(fn, fit_range=40e3)
    params = Ufit.get_fit_param(fn)
    assert len(params) == N_RESO

    # per-resonator error statistics via nearest-truth matching (robust
    # to ordering): every fitted peak must land on its own resonator
    got = np.array([1e6 * p["f0"] for p in params])
    truth = np.sort([RF + r["f0"] for r in resos])
    d = np.abs(got[:, None] - truth[None, :])
    assign = d.argmin(axis=1)
    f0_err = d.min(axis=1)
    assert len(set(assign.tolist())) == N_RESO, \
        "each fit must match a distinct resonator"
    assert np.median(f0_err) < 3_000, \
        f"median f0 error {np.median(f0_err):.0f} Hz"
    assert np.percentile(f0_err, 90) < 10_000, \
        f"p90 f0 error {np.percentile(f0_err, 90):.0f} Hz"
    assert np.max(f0_err) < 20_000, f"max f0 error {np.max(f0_err):.0f} Hz"

    # Qr statistics on the matched pairs (truth Qr is defined on the
    # baseband f0; the fit's on RF + f0 — rescale before comparing)
    truth_by_f0 = sorted(resos, key=lambda r: RF + r["f0"])
    qr_rel = []
    for p, ti in zip(params, assign):
        r = truth_by_f0[ti]
        qr_true_abs = r["Qr"] * (RF + r["f0"]) / r["f0"]
        qr_rel.append(abs(p["Qr"] - qr_true_abs) / qr_true_abs)
    qr_rel = np.asarray(qr_rel)
    assert np.median(qr_rel) < 0.2, \
        f"median Qr rel err {np.median(qr_rel):.2f}"
    assert np.mean(qr_rel < 0.5) > 0.9, "more than 10% of Qr off by >50%"

    # 4) readout tones from the fit, then multi-tone noise at those tones
    rf, rel_tones = Ufit.get_tones(fn)
    assert rf == RF and len(rel_tones) == N_RESO
    nf = Unoise.Get_noise(list(rel_tones), measure_t=0.2, rate=RATE,
                          decimation=500, RF=RF, mode="DIRECT",
                          output_filename="noise_array", channel=chan)
    Unoise.calculate_noise(nf, welch=2)
    ninfo, freq_axis, real, imag = Ufiles.get_noise(nf)
    assert ninfo["n_chan"] == N_RESO
    assert len(real) == N_RESO and len(imag) == N_RESO
    assert all(np.isfinite(r).all() for r in real)
    assert all(np.isfinite(i).all() for i in imag)

    # on-resonance readout: each channel's steady amplitude must sit in
    # the resonator dip (|S21| < 1), not at the off-resonance rail
    data = Ufiles.openH5file(nf)
    assert data.shape[0] == N_RESO
    steady = np.abs(data[:, 8:]).mean(axis=1)
    assert np.mean(steady < 0.95) > 0.9, \
        f"only {np.mean(steady < 0.95):.0%} of channels in the dip"
