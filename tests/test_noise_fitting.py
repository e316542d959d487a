"""End-to-end noise acquisition + resonator fitting workflow tests
(reference workflow: scripts/get_VNA.py -> fit_VNA.py -> get_noise.py ->
analyze_noise.py)."""

import numpy as np
import pytest

from gpu_sdr.client import fitting as Ufit
from gpu_sdr.client import files as Ufiles
from gpu_sdr.client import noise as Unoise
from gpu_sdr.client import vna as Uvna
from gpu_sdr.engine.channel import make_resonator_channel


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_get_noise_direct_and_psd(tmp_chdir):
    """DIRECT-mode noise acquisition with additive noise: PSD of each
    channel must be flat at the injected noise level."""
    from gpu_sdr.engine.channel import ChainChannel, IdealChannel
    rate = int(1e6)
    tones = [100_000, -150_000]
    chan = ChainChannel([IdealChannel()], noise_rms=1e-3, seed=5)
    fn = Unoise.Get_noise(tones, measure_t=0.5, rate=rate, decimation=100,
                          RF=10_000_000, mode="DIRECT",
                          output_filename="noise_direct", channel=chan)
    info = Ufiles.get_rx_info(fn)
    assert info.decim == 100
    assert [f + info.tone for f in info.freq] == \
        [10_000_000 + t for t in tones]

    Unoise.calculate_noise(fn, welch=4)
    ninfo, freq, real, imag = Ufiles.get_noise(fn)
    assert ninfo["n_chan"] == 2
    assert ninfo["rate"] == rate / 100
    assert len(real) == 2 and len(imag) == 2
    assert ninfo["tones"][0] == 10_000_000 + tones[0]
    # PSD should be finite and roughly flat
    assert np.isfinite(real[0]).all()


def test_get_noise_pfb_quantization(tmp_chdir):
    """PFB-mode noise: tones are quantized to bin centers and the command
    uses the minimum-spacing PFB size (reference USRP_noise.py:500-530)."""
    rate = int(1e6)
    tones = [100_000, 120_000]    # spacing 20 kHz -> >= 50 bins
    cmd = Unoise.compose_noise_command(tones, 0.1, rate, RF=0, mode="PFB")
    rx = cmd.A_RX2
    assert rx.fft_tones >= 50
    bin_w = rate / rx.fft_tones
    for f in rx.freq:
        assert abs(f / bin_w - round(f / bin_w)) < 1e-6
    fn = Unoise.Get_noise(tones, measure_t=0.2, rate=rate, mode="PFB",
                          RF=0, output_filename="noise_pfb")
    data = Ufiles.openH5file(fn)
    assert data.shape[0] == 2
    # each tone demodulated to a ~constant amplitude
    steady = data[:, 16:]
    assert np.abs(steady).std() < 0.05 * np.abs(steady).mean()


def test_full_fitting_workflow(tmp_chdir):
    """VNA over two simulated resonators -> initialize_peaks -> vna_fit
    recovers f0 and Qr; get_best_readout/get_tones give sensible values."""
    rate = int(1e6)
    resos = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0),
             dict(f0=200_000.0, Qr=25.0, Qe_re=50.0)]

    chan = make_resonator_channel(rate, resos, fft_len=1 << 12)
    from gpu_sdr.client import delay as Udelay
    Udelay.set_line_delay(rate, 512e-6 * 1e9)   # channel causal shift
    try:
        fn = Uvna.Single_VNA(start_f=-400_000, last_f=400_000,
                             measure_t=0.4, n_points=1600, tx_gain=0,
                             Rate=rate, RF=10_000_000,
                             output_filename="vna_fit_wf", channel=chan)
        Uvna.VNA_analysis(fn)
    finally:
        Udelay.LINE_DELAY.clear()

    ok = Ufit.initialize_peaks(fn, N_peaks=2, peak_width=50e3,
                               Qr_cutoff=5, Mag_depth_cutoff=0.5,
                               exclude_center=False)
    inits = Ufiles.get_init_peaks(fn)
    assert len(inits) == 2, f"found {len(inits)} peaks"
    assert ok

    assert Ufit.vna_fit(fn, fit_range=60e3)
    params = Ufit.get_fit_param(fn)
    assert len(params) == 2
    f0s = sorted(1e6 * p["f0"] for p in params)
    expect = sorted(10_000_000 + r["f0"] for r in resos)
    for got, exp in zip(f0s, expect):
        assert abs(got - exp) < 10_000, (got, exp)
    for p in params:
        assert np.isfinite(p["Qr"]) and p["Qr"] > 0

    data = Ufit.get_fit_data(fn)
    assert len(data) == 2
    assert len(data[0]["fitted"]) == len(data[0]["frequency"])
    # the fitted model must track the measured S21 closely
    for d in data:
        resid = np.linalg.norm(d["fitted"] - d["original"]) / \
            np.linalg.norm(d["original"])
        # the simulated channel is not exactly the fit model (baseband
        # normalization + lock-in smoothing): allow a modest residual
        assert resid < 0.2, resid

    bro = Ufit.get_best_readout(fn)
    assert len(bro) == 2
    rf, rel = Ufit.get_tones(fn)
    assert rf == 10_000_000
    spacing = Ufit.min_readout_spacing(fn)
    assert 300_000 < spacing < 400_000


def test_nonlinear_model_roundtrip():
    """do_fit recovers parameters of a synthetic nonlinear_model trace."""
    f = np.linspace(99.95e6, 100.05e6, 400)
    truth = dict(f0=100.0, A=1.0, phi=0.01, D=0.0, dQr=1.0 / 20000,
                 dQe_re=1.0 / 40000, dQe_im=0.0, a=0.1)
    z = Ufit.complex_of_real(Ufit.nonlinear_model(f, *truth.values()))
    f0, Qi, Qr, zfit, modelwise = Ufit.do_fit(f, z.real, z.imag)
    assert abs(f0 - 100.0) < 1e-3
    assert abs(Qr - 20000) / 20000 < 0.05
    assert abs(modelwise[8] - 0.1) < 0.05    # nonlinearity a


def test_amplitude_trigger_from_vna_file(tmp_chdir):
    """amplitude_trigger(vna=...) loads fit params and calibration from a
    fitted VNA file (the reference's construction path)."""
    from gpu_sdr.client.triggers import amplitude_trigger

    rate = int(1e6)
    resos = [dict(f0=150_000.0, Qr=25.0, Qe_re=50.0)]
    chan = make_resonator_channel(rate, resos, fft_len=1 << 12)
    from gpu_sdr.client import delay as Udelay
    Udelay.set_line_delay(rate, 512e-6 * 1e9)
    try:
        fn = Uvna.Single_VNA(start_f=-400_000, last_f=400_000,
                             measure_t=0.2, n_points=800, tx_gain=0,
                             Rate=rate, RF=10_000_000,
                             output_filename="vna_for_trig", channel=chan)
        Uvna.VNA_analysis(fn)
    finally:
        Udelay.LINE_DELAY.clear()
    assert Ufit.initialize_peaks(fn, N_peaks=1, peak_width=50e3,
                                 Qr_cutoff=5, Mag_depth_cutoff=0.5,
                                 exclude_center=False)
    Ufit.vna_fit(fn, fit_range=60e3)

    trig = amplitude_trigger(sample_rate=10_000, threshold=5, vna=fn)
    assert trig.fit_params and len(trig.fit_params) == 1
    assert trig.cal > 0
    # feed data through the frequency-conversion path
    n = int(1.2 * 10_000 * 10)   # > accumulation at default 10 s? use 0.5
    trig.accum = 0.5
    data = np.ones(10_000, dtype=np.complex64) * 0.5
    md = {"channels": 1, "length": 10_000}
    out, md2 = trig.trigger(data, dict(md))
    assert md2["length"] >= 0   # ran the conversion without error
