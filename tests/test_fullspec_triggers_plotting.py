"""Tests for full-spectrum acquisition, trigger framework, and plotting."""

import os

import numpy as np
import pytest

from gpu_sdr.client import files as Ufiles
from gpu_sdr.client import full_spec as Ufs
from gpu_sdr.client import noise as Unoise
from gpu_sdr.client import plotting as Uplot
from gpu_sdr.client import triggers as Utrig
from gpu_sdr.client import vna as Uvna


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_nodsp_raw_capture(tmp_chdir):
    rate = int(1e6)
    fn = Ufs.get_NODSP_tones([50_000], measure_t=0.1, rate=rate, RF=0,
                             output_filename="raw_cap")
    data = Ufiles.openH5file(fn)
    assert data.shape[0] == 1
    # raw tone comb present at full amplitude
    assert np.abs(data[0, 1000:]).mean() == pytest.approx(1.0, abs=0.05)
    info = Ufiles.get_rx_info(fn)
    assert info.wave_type[0].value == "NODSP"


def test_full_spec_spectrogram(tmp_chdir):
    rate = int(1_024_000)
    nfft = 64
    tone = 5 * rate // nfft
    fn = Ufs.Get_full_spec([tone], channels=nfft, measure_t=0.2, rate=rate,
                           RF=0, output_filename="pfb_spec")
    data = Ufiles.openH5file(fn)
    # NOISE mode stores the spectra stream flattened in one channel
    # (reference Param_to_H5 / plot_pfb reshape convention)
    assert data.shape[0] == 1
    frames = data[0][:len(data[0]) // nfft * nfft].reshape(-1, nfft)
    power = np.mean(np.abs(frames[8:]) ** 2, axis=0)
    assert np.argmax(power) == 5     # tone lands in its bin
    out = Uplot.plot_pfb(fn, output_filename="pfb_plot")
    assert os.path.exists(out)


def test_full_spec_decimation(tmp_chdir):
    rate = int(1_024_000)
    nfft = 64
    fn = Ufs.Get_full_spec([rate // nfft], channels=nfft, measure_t=0.2,
                           rate=rate, RF=0, decimation=4,
                           output_filename="pfb_decim")
    info = Ufiles.get_rx_info(fn)
    assert info.decim == 4
    data = Ufiles.openH5file(fn)
    # 4x fewer samples than undecimated (flattened single channel),
    # capped at the expected acquisition length
    assert data.shape[0] == 1
    assert data.shape[1] == int(np.ceil(info.samples / 4))


def test_trigger_suppresses_writes(tmp_chdir):
    """A trigger that always rejects keeps the file empty; passthrough
    writes everything."""

    class RejectAll(Utrig.trigger_template):
        def trigger(self, data, metadata):
            metadata["length"] = 0
            return np.array([]), metadata

    rate = int(1e6)
    fn = Unoise.Get_noise([10_000], measure_t=0.1, rate=rate, RF=0,
                          decimation=100, mode="DIRECT",
                          output_filename="trig_rej", trigger=RejectAll())
    with Ufiles.bound_open(fn) as f:
        ds = f["raw_data0"]["A_RX2"]["data"]
        assert ds.attrs["samples"] == 0


def test_amplitude_trigger_finds_glitch(tmp_chdir):
    """Feed a stream with an injected amplitude glitch through
    amplitude_trigger: it must record windows and bookkeep the glitch."""
    rate = 1000.0
    trig = Utrig.amplitude_trigger(sample_rate=rate, threshold=5,
                                   fit_params=None, channels=[0],
                                   accumulation_t=2.0, window_t=0.01)
    n = int(2.5 * rate)
    data = np.ones(n, dtype=np.complex64)
    data[1200] += 10.0       # glitch
    md = {"channels": 1, "length": n}
    out, md2 = trig.trigger(data, dict(md))
    assert md2["length"] > 0
    assert len(trig.nglitch) == 1
    assert trig.nglitch[0] >= 1
    # windows: 2 noise + >=1 glitch, each 4*window_t*rate samples
    win = int(4 * 0.01 * rate)
    assert md2["length"] % win == 0
    assert md2["length"] // win >= 3


def test_plotting_outputs(tmp_chdir):
    rate = int(1e6)
    fn = Uvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=100, tx_gain=0, Rate=rate, RF=0,
                         output_filename="vna_plot")
    Uvna.VNA_analysis(fn)
    out = Uplot.plot_VNA(fn, output_filename="vna_fig")
    assert os.path.exists(out)
    nf = Unoise.Get_noise([10_000], measure_t=0.2, rate=rate, RF=0,
                          decimation=100, mode="DIRECT",
                          output_filename="noise_plot")
    Unoise.calculate_noise(nf, welch=2)
    out2 = Uplot.plot_noise_spec(nf, output_filename="noise_fig")
    assert os.path.exists(out2)
    out3 = Uplot.plot_raw_data(nf, output_filename="raw_fig")
    assert os.path.exists(out3)
    out4 = Uplot.diagnostic_VNA_noise(nf, fn, output_filename="diag_fig")
    assert os.path.exists(out4)


def test_plotting_html_backend(tmp_chdir):
    """The interactive backend writes self-contained HTML with the trace
    data embedded (reference plotly parity: plot_VNA
    pyUSRP/USRP_VNA.py:807-1100); unknown backends raise."""
    rate = int(1e6)
    fn = Uvna.Single_VNA(start_f=-100_000, last_f=100_000, measure_t=0.05,
                         n_points=100, tx_gain=0, Rate=rate, RF=0,
                         output_filename="vna_plot_h")
    Uvna.VNA_analysis(fn)
    out = Uplot.plot_VNA(fn, backend="plotly", output_filename="vna_h")
    assert out.endswith(".html") and os.path.exists(out)
    body = open(out).read()
    assert "<svg" in body or "svg" in body
    assert "S21 Magnitude" in body
    nf = Unoise.Get_noise([10_000], measure_t=0.2, rate=rate, RF=0,
                          decimation=100, mode="DIRECT",
                          output_filename="noise_plot_h")
    Unoise.calculate_noise(nf, welch=2)
    out2 = Uplot.plot_noise_spec(nf, backend="html",
                                 output_filename="noise_h")
    assert os.path.exists(out2) and "PSD" in open(out2).read()
    out3 = Uplot.plot_raw_data(nf, backend="plotly",
                               output_filename="raw_h")
    assert os.path.exists(out3)
    out4 = Uplot.diagnostic_VNA_noise(nf, fn, backend="plotly",
                                      output_filename="diag_h")
    assert os.path.exists(out4)
    with pytest.raises(ValueError, match="backend"):
        Uplot.plot_VNA(fn, backend="gnuplot")


def test_plot_resonators_html(tmp_chdir):
    """Fit resonators (simulated channel) then render the interactive
    resonator grid."""
    from gpu_sdr.client import fitting as Ufit
    from gpu_sdr.engine.channel import make_resonator_channel
    rate = int(1e6)
    chan = make_resonator_channel(
        rate, [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0)],
        fft_len=1 << 12)
    fn = Uvna.Single_VNA(start_f=-400_000, last_f=400_000, measure_t=0.2,
                         n_points=800, tx_gain=0, Rate=rate, RF=0,
                         output_filename="vna_reso_h", channel=chan)
    Uvna.VNA_analysis(fn)
    assert Ufit.initialize_peaks(fn, N_peaks=1, peak_width=50e3,
                                 Qr_cutoff=5, Mag_depth_cutoff=0.5,
                                 exclude_center=False)
    assert Ufit.vna_fit(fn, fit_range=60e3)
    out = Uplot.plot_resonators(fn, backend="plotly",
                                output_filename="reso_h")
    assert out.endswith(".html") and os.path.exists(out)
    assert "reso 0" in open(out).read()


def test_plot_pfb_and_timestream_html(tmp_chdir):
    """HTML backend for the waterfall plots (embedded data-URI heatmap +
    interactive axes)."""
    rate = int(1_024_000)
    fn = Ufs.Get_full_spec([5 * rate // 64], channels=64, measure_t=0.1,
                           rate=rate, RF=0, output_filename="fs_html")
    out = Uplot.plot_pfb(fn, backend="plotly", output_filename="pfb_h")
    assert out.endswith(".html") and os.path.exists(out)
    assert "data:image/png;base64" in open(out).read()

    from gpu_sdr.client import vna as Uvna2
    fn2 = Uvna2.Single_VNA(start_f=-100_000, last_f=100_000,
                           measure_t=0.05, n_points=100, tx_gain=0,
                           Rate=int(1e6), RF=0, iterations=3,
                           output_filename="vna_ts_h")
    Uvna2.VNA_timestream_analysis(fn2)
    out2 = Uplot.VNA_timestream_plot(fn2, backend="html",
                                     output_filename="vnats_h")
    assert os.path.exists(out2)
    assert "data:image/png;base64" in open(out2).read()
