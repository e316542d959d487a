"""The pyusrp facade must expose every public name of the reference
client library (pyUSRP/*.py `def`/`class` at module scope), so reference
workflows port by changing only their import line."""

import numpy as np
import pytest

import gpu_sdr.pyusrp as u

# Complete public-name inventory of the reference pyUSRP package
# (grep '^def |^class ' over pyUSRP/USRP_*.py).
REFERENCE_NAMES = """
Dual_VNA Single_VNA VNA_timestream_analysis VNA_timestream_plot
VNA_analysis plot_VNA
reinit_data_socket reinit_async_socket clean_data_queue Packets_to_file
USRP_socket_bind Decode_Sync_Header Print_Sync_Header Decode_Async_header
Decode_Async_payload Encode_async_message Async_send Async_thread
Wait_for_async_connection Wait_for_sync_connection Start_Async_RX
Stop_Async_RX Connect Disconnect force_ternimate Sync_RX signal_handler
Start_Sync_RX Stop_Sync_RX
linear_phase
measure_line_delay write_delay_to_file analyze_line_delay
load_delay_from_file set_line_delay load_delay_from_folder
format_filename bound_open chk_multi_usrp get_receivers get_rx_info
get_tx_info openH5file get_noise get_trigger_info get_readout_power
global_parameter Device_chk Front_end_chk Param_to_H5 is_VNA_analyzed
get_VNA_data get_dynamic_VNA_data get_init_peaks is_VNA_dynamic_analyzed
real_of_complex complex_of_real nonlinear_model S21_func FWMH do_fit
extimate_peak_number initialize_peaks initialize_from_VNA vna_fit
get_fit_data get_fit_param get_best_readout min_readout_spacing
plot_resonators plot_reso_stat get_tones
get_NODSP_tones Get_full_spec plot_pfb
mgr_init nostdout to_list_of_str print_warning print_error print_debug
print_line get_timestamp vrms2dbm dbm2vrms find_nearest
average_tones_diff quantize_tones
dual_get_noise Get_noise spec_from_samples calculate_noise
plot_noise_spec calculate_frequency_timestream copy_resonator_group
get_frequency_timestreams plot_frequency_timestreams diagnostic_VNA_noise
calculate_NEF_spectra get_NEF_spec plot_NEF_spectra
get_color style_plotly_figure plot_raw_data
trigger_template deriv_test amplitude_trigger
""".split()


def test_facade_wire_constants():
    """P1 module constants (USRP_low_level): the RX_wrapper header dtype,
    payload dtype and server addresses."""
    import numpy as _np
    assert u.data_type is _np.complex64
    assert u.header_type.itemsize == 21
    assert [n for n, *_ in u.header_type.descr] == [
        "usrp_number", "front_end_code", "packet_number", "length",
        "errors", "channels"]
    assert u.USRP_server_address[1] == 22001
    assert u.USRP_server_address_data[1] == 61360


def test_facade_covers_reference_namespace():
    missing = [n for n in REFERENCE_NAMES if not hasattr(u, n)]
    assert not missing, f"pyusrp facade missing reference names: {missing}"


def test_connection_plumbing_shims():
    # no active connection: these degrade gracefully
    assert u.reinit_data_socket() is None
    assert u.reinit_async_socket() is None
    assert u.clean_data_queue() == 0
    assert u.Async_thread() is False
    assert u.Sync_RX() is False
    u.force_ternimate()          # no-op without a connection
    u.signal_handler(2, None)    # prints a warning, no crash
    u.Decode_Async_payload('{"type": "nack"}')
    u.Decode_Async_payload("not json")


def test_clean_data_queue_counts():
    import queue
    q = queue.Queue()
    for i in range(5):
        q.put((None, np.zeros(4, np.complex64)))
    assert u.clean_data_queue(q) == 5
    assert u.clean_data_queue(q) == 0


def test_usrp_socket_bind_timeout():
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.settimeout(0.2)
    try:
        # nothing listens on this port; must return False after ~timeout
        assert u.USRP_socket_bind(s, ("127.0.0.1", 1), 0.0) is False
    finally:
        s.close()


def test_print_sync_header(capsys):
    u.Print_Sync_Header({"usrp_number": 0, "front_end_code": 65,
                         "packet_number": 3, "length": 100, "errors": 0,
                         "channels": 2})
    out = capsys.readouterr().out
    assert "packet_number: 3" in out and "channels: 2" in out


def test_style_plotly_figure():
    fig = {"layout": {}}
    u.style_plotly_figure(fig)
    assert fig["layout"]["paper_bgcolor"] == "rgba(0,0,0,0)"
    assert fig["layout"]["plot_bgcolor"] == "rgba(0,0,0,0)"


def test_mgr_init_restores(monkeypatch):
    import signal
    called = {}
    monkeypatch.setattr(signal, "signal",
                        lambda s, h: called.setdefault("args", (s, h)))
    u.mgr_init()
    assert called["args"] == (signal.SIGINT, signal.SIG_IGN)
