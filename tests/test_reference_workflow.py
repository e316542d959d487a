"""The pyusrp facade driven by the REFERENCE workflows' argument flow.

Reproduces, call for call, what the reference's measurement + analysis
scripts do against `import pyUSRP as u` — here `import gpu_sdr.pyusrp
as u` is the ONLY changed line, proving the drop-in claim:

  * scripts/get_VNA.py:14-42  — LINE_DELAY probe -> measure_line_delay ->
    analyze_line_delay -> write_delay_to_file -> load_delay_from_file ->
    Single_VNA (all reference kwargs)
  * scripts/fit_VNA.py:18-33  — extimate_peak_number / initialize_peaks
    -> vna_fit -> plot_resonators -> plot_VNA (all reference kwargs)

The physical line (cryostat + resonators) is simulated by a
FrequencyResponseChannel passed through the measurement functions'
`channel=` hook — the one extra argument, standing in for the radio.

The facade's connection-plumbing shims (the names pyUSRP exposes because
its sockets are module globals) are exercised against a live loopback
server in test_facade_connection_shims.
"""

import numpy as np
import pytest

import gpu_sdr.pyusrp as u
from gpu_sdr.engine.channel import make_resonator_channel

RATE = 1_000_000
RF = 10_000_000
RESOS = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0),
         dict(f0=200_000.0, Qr=25.0, Qe_re=50.0)]


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    u.LINE_DELAY.clear()
    yield tmp_path
    u.LINE_DELAY.clear()


def _get_vna_flow(gain, iter_, rate, freq, front_end, f0, f1, lapse,
                  points, ntones, delay_duration, channel_factory):
    """scripts/get_VNA.py run() (reference :14-42), verbatim argument
    flow; `channel_factory` injects the simulated line."""
    try:
        if u.LINE_DELAY[str(int(rate / 1e6))]:
            pass
    except KeyError:
        filename = u.measure_line_delay(
            rate, freq, front_end, USRP_num=0, tx_gain=0, rx_gain=0,
            output_filename=None, compensate=True,
            duration=delay_duration, channel=channel_factory())
        delay = u.analyze_line_delay(filename, True)
        u.write_delay_to_file(filename, delay)
        u.load_delay_from_file(filename)
        if ntones == 1:
            ntones = None
    return u.Single_VNA(start_f=f0, last_f=f1, measure_t=lapse,
                        n_points=points, tx_gain=gain, Rate=rate,
                        decimation=True, RF=freq, Front_end=front_end,
                        Device=None, output_filename=None,
                        Multitone_compensation=ntones, Iterations=iter_,
                        verbose=False, channel=channel_factory())


def _fit_vna_flow(file_list, backend, N_peaks, smoothing, a_cutoff,
                  threshold, peak_width, Mag_depth_cutoff, Qr_cutoff):
    """scripts/fit_VNA.py run() (reference :18-33), verbatim argument
    flow (Qr_cutoff parameterized: the reference hardcodes 4e3 for
    GHz-Q MKIDs; the simulated line has Qr ~ 30)."""
    for i in range(len(file_list)):
        if threshold is not None:
            u.extimate_peak_number(
                file_list[i], threshold=threshold, smoothing=smoothing,
                peak_width=peak_width, verbose=False, exclude_center=True,
                diagnostic_plots=True)
        else:
            u.initialize_peaks(
                file_list[i], N_peaks=N_peaks[i], a_cutoff=a_cutoff,
                smoothing=smoothing, peak_width=peak_width,
                Qr_cutoff=Qr_cutoff, verbose=True, exclude_center=True,
                diagnostic_plots=True, Mag_depth_cutoff=Mag_depth_cutoff)
        u.vna_fit(file_list[i], p0=None, fit_range=peak_width,
                  verbose=False)
        single_plots = backend == "matplotlib"
        u.plot_resonators(file_list[i], reso_freq=None, backend="plotly",
                          title_info=None, verbose=False,
                          output_filename=None, auto_open=False,
                          attenuation=None, single_plots=single_plots)
        u.plot_VNA(file_list[i], backend="plotly", auto_open=False)


def test_reference_get_vna_fit_vna_workflow(tmp_chdir):
    import glob
    import os

    assert u.Connect()          # in-process engine: no server needed

    def channel():
        return make_resonator_channel(RATE, RESOS, fft_len=1 << 12)

    vna_filename = _get_vna_flow(
        gain=0, iter_=1, rate=RATE, freq=RF, front_end="A",
        f0=-400_000, f1=400_000, lapse=0.4, points=1600, ntones=1,
        delay_duration=0.5, channel_factory=channel)
    # the delay-calibration leg measured the channel's causal group
    # delay and loaded it into LINE_DELAY for the VNA
    assert u.LINE_DELAY[str(int(RATE / 1e6))] > 0

    u.VNA_analysis(vna_filename)
    assert u.is_VNA_analyzed(vna_filename)

    files = sorted(glob.glob("USRP_VNA*.h5"))
    assert files == [u.format_filename(vna_filename)]
    _fit_vna_flow(files, backend="plotly", N_peaks=[2], smoothing=None,
                  a_cutoff=10, threshold=None, peak_width=50e3,
                  Mag_depth_cutoff=0.5, Qr_cutoff=5)
    params = u.get_fit_param(files[0])
    assert len(params) == 2
    f0s = sorted(1e6 * p["f0"] for p in params)
    expect = sorted(RF + r["f0"] for r in RESOS)
    for got, exp in zip(f0s, expect):
        assert abs(got - exp) < 10_000, (got, exp)
    # the diagnostic artifacts + interactive plots the reference flow emits
    assert glob.glob("peaks_init_*.png")
    assert glob.glob("USRP_resonators*.html")
    assert glob.glob("USRP_VNA*.html") or glob.glob("*VNA*.html")

    # the threshold branch of fit_VNA.py (extimate_peak_number path)
    _fit_vna_flow(files, backend="matplotlib", N_peaks=[2],
                  smoothing=None, a_cutoff=10, threshold=0.5,
                  peak_width=50e3, Mag_depth_cutoff=0.5, Qr_cutoff=5)
    assert glob.glob("peak_number_estimation_*.png")
    assert u.Disconnect() in (True, None)
    assert os.path.exists(files[0])


def test_facade_connection_shims():
    """Every connection-plumbing shim the reference exposes (its sockets
    are module globals) behaves correctly against a live loopback
    server: exercised or dead — none silently padded."""
    import socket

    from gpu_sdr.server.main import Server

    srv = Server(async_port=0, data_port=0, host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    try:
        # not connected yet: the passive shims report that state
        assert u.Async_thread() is False
        assert u.Sync_RX() is False
        assert u.Wait_for_async_connection() is False
        assert u.Wait_for_sync_connection() is False
        assert u.clean_data_queue() == 0

        assert u.Connect(host="127.0.0.1", async_port=a_port,
                         sync_port=d_port)
        assert u.Async_thread() is True
        assert u.Sync_RX() is True
        assert u.Wait_for_async_connection() is True
        assert u.Wait_for_sync_connection() is True
        assert u.Start_Async_RX() and u.Start_Sync_RX()
        assert u.Stop_Async_RX() and u.Stop_Sync_RX()
        assert u.reinit_data_socket() is None
        assert u.reinit_async_socket() is None

        # a residual packet in the data queue is drained + counted
        conn = u.get_connection()
        conn.data_queue.put(({"packet_number": 0}, np.zeros(4)))
        assert u.clean_data_queue() == 1
        assert u.clean_data_queue() == 0

        # EOM ack routing through the reference's payload decoder
        assert not conn.end_of_measure.is_set()
        u.Decode_Async_payload('{"type": "ack", "payload": "EOM"}')
        assert conn.end_of_measure.is_set()

        # header pretty-printer + socket binder
        u.Print_Sync_Header({k: 0 for k in
                             ("usrp_number", "front_end_code",
                              "packet_number", "length", "errors",
                              "channels")})
        s = socket.socket()
        try:
            assert u.USRP_socket_bind(s, ("127.0.0.1", a_port), 5.0) \
                in (True, False)
        finally:
            s.close()

        u.signal_handler(None, None)       # sets end_of_measure
        assert conn.end_of_measure.is_set()
        u.force_ternimate()                # closes the connection
    finally:
        try:
            u.Disconnect()
        except Exception:
            pass
        srv.close()

    assert u.Device_chk(3) is True
    assert u.Front_end_chk("A") and not u.Front_end_chk("Q")
    assert u.to_list_of_str("x") == ["x"]
    assert u.average_tones_diff([1.0, 2.0], [1.0, 2.5]) == 0.25
    with u.nostdout():
        print("swallowed")
    u.print_line("")
    u.mgr_init()
    assert len(u.get_timestamp()) > 0
