"""pyUSRP facade completeness + replay-file ingest tests."""

import numpy as np
import pytest

import gpu_sdr.pyusrp as u
from gpu_sdr import golden
from gpu_sdr.engine.sources import ReplaySource
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType


def test_facade_exports_reference_api():
    """Every name a reference workflow uses must exist on the facade."""
    names = [
        # low level
        "print_error", "print_warning", "print_debug", "get_timestamp",
        "vrms2dbm", "dbm2vrms", "quantize_tones", "find_nearest",
        "USRP_power", "USRP_calibration", "USRP_accepted_rates",
        # connections
        "Connect", "Disconnect", "Async_send", "Packets_to_file",
        # files
        "openH5file", "get_rx_info", "get_tx_info", "bound_open",
        "format_filename", "Param_to_H5", "get_noise", "get_VNA_data",
        "is_VNA_analyzed", "get_init_peaks", "get_readout_power",
        "global_parameter",
        # VNA
        "Single_VNA", "Dual_VNA", "VNA_analysis",
        "VNA_timestream_analysis", "plot_VNA", "VNA_timestream_plot",
        # noise
        "Get_noise", "dual_get_noise", "calculate_noise",
        "spec_from_samples", "copy_resonator_group",
        "get_frequency_timestreams", "calculate_frequency_timestream",
        "plot_noise_spec", "diagnostic_VNA_noise",
        "plot_frequency_timestreams",
        # fitting
        "nonlinear_model", "S21_func", "do_fit", "extimate_peak_number",
        "initialize_peaks", "initialize_from_VNA", "vna_fit",
        "get_fit_data", "get_fit_param", "get_best_readout",
        "min_readout_spacing", "get_tones", "plot_resonators",
        # delay
        "LINE_DELAY", "measure_line_delay", "analyze_line_delay",
        "write_delay_to_file", "load_delay_from_file",
        "load_delay_from_folder", "set_line_delay",
        # full spec
        "Get_full_spec", "get_NODSP_tones", "plot_pfb",
        # triggers
        "trigger_template", "deriv_test", "amplitude_trigger",
        # plotting / analysis
        "plot_raw_data", "get_color", "linear_phase",
    ]
    missing = [n for n in names if not hasattr(u, n)]
    assert not missing, f"facade missing: {missing}"


def test_global_parameter_set_get():
    gp = u.global_parameter()
    assert gp.set("A_RX2", "mode", "RX")
    assert gp.set("A_RX2", "rate", 1_000_000)
    assert gp.set("A_RX2", "rf", 300_000_000)
    assert gp.set("A_RX2", "wave_type", ["DIRECT"])
    assert gp.get("A_RX2", "rf") == 300_000_000
    assert gp.get("A_RX2", "mode") == AntMode.RX
    assert gp.self_check()


def test_replay_source_measurement(tmp_path, monkeypatch):
    """Record IQ to disk, replay it through a DIRECT demod, and verify the
    demodulated output matches the golden model of the same stream."""
    monkeypatch.chdir(tmp_path)
    rate = 1_000_000
    f0 = 123_456
    n = np.arange(300_000, dtype=np.int64)
    x = (0.7 * np.exp(2j * np.pi * ((f0 * (n % rate)) % rate) / rate)
         ).astype(np.complex64)
    path = str(tmp_path / "recording.npy")
    np.save(path, x)

    cmd = UsrpParams()
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=300_000,
        decim=100, pf_average=4, freq=[f0],
        wave_type=[WaveType.DIRECT], delay=1.0)
    fn = u.run_measurement(cmd, "replay_meas",
                           source=ReplaySource(path))
    data = u.openH5file(fn)
    steady = data[0, 8:]
    assert np.allclose(np.abs(steady), 0.7, atol=2e-3)


def test_replay_source_loop_and_pad(tmp_path):
    src = ReplaySource.__new__(ReplaySource)
    src.data = np.arange(10, dtype=np.complex64)
    src.loop = True
    blocks = list(src.blocks(8, 3))
    assert np.array_equal(blocks[0], np.arange(8))
    assert np.array_equal(blocks[1], [8, 9, 0, 1, 2, 3, 4, 5])
    src2 = ReplaySource.__new__(ReplaySource)
    src2.data = np.arange(10, dtype=np.complex64)
    src2.loop = False
    blocks = list(src2.blocks(8, 2))
    assert np.array_equal(blocks[1], [8, 9, 0, 0, 0, 0, 0, 0])
