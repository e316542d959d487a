"""Server session robustness: many sequential measurements over one
connection (the reference crashed after ~83 measures — reset_usrp_host,
cpp/USRP_hardware_manager.cpp:8-52) and dual-RX streaming."""

import threading

import numpy as np
import pytest

from gpu_sdr.client import connections as Uconn
from gpu_sdr.client import files as Ufiles
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType
from gpu_sdr.server.main import Server


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _cmd(freq, samples=100_000, fe="A"):
    cmd = UsrpParams()
    setattr(cmd, f"{fe}_TXRX", AntennaParams(
        mode=AntMode.TX, rate=1_000_000, buffer_len=100_000,
        samples=samples, freq=[freq], ampl=[0.5],
        wave_type=[WaveType.TONES], delay=1.0))
    setattr(cmd, f"{fe}_RX2", AntennaParams(
        mode=AntMode.RX, rate=1_000_000, buffer_len=100_000,
        samples=samples, decim=100, pf_average=4, freq=[freq],
        wave_type=[WaveType.DIRECT], delay=1.0))
    return cmd


def test_many_sequential_measurements(tmp_chdir):
    """Five measurements back-to-back on one connection, each correct."""
    srv = Server(async_port=0, data_port=0, host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            srv.serve_one(timeout=0.5)

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)
    try:
        for i in range(5):
            cmd = _cmd(freq=10_000 * (i + 1))
            conn.send_params(cmd)
            fn = Uconn.Packets_to_file(conn, cmd, filename=f"seq_{i}",
                                       progress=False)
            data = Ufiles.openH5file(fn)
            assert data.shape == (1, 1000)
            assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3), i
    finally:
        stop.set()
        conn.close()
        srv.close()


def test_dual_rx_over_tcp(tmp_chdir):
    """Dual-frontend measurement over TCP: packets route by front-end code
    into the right H5 groups."""
    srv = Server(async_port=0, data_port=0, host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    worker = threading.Thread(target=lambda: srv.serve_one(timeout=20),
                              daemon=True)
    worker.start()
    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)
    try:
        cmd = _cmd(freq=50_000, fe="A")
        b = _cmd(freq=-70_000, fe="B")
        cmd.B_TXRX = b.B_TXRX
        cmd.B_RX2 = b.B_RX2
        conn.send_params(cmd)
        fn = Uconn.Packets_to_file(conn, cmd, filename="dual_tcp",
                                   progress=False)
        worker.join(timeout=30)
        for ant in ("A_RX2", "B_RX2"):
            data = Ufiles.openH5file(fn, front_end=ant)
            assert data.shape == (1, 1000), ant
            assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3), ant
    finally:
        conn.close()
        srv.close()


@pytest.mark.parametrize("use_native", [False, True])
def test_client_reconnect(tmp_chdir, use_native):
    """A client that disconnects entirely and reconnects gets served again
    (the reference's reconnect_data/reconnect_async + virtual_pinger
    watchdog, cpp/USRP_server_network.cpp:3-4,135-161) — on both the
    Python and the native C++ data plane."""
    if use_native:
        from gpu_sdr.server import native as native_mod
        if not native_mod.available():
            pytest.skip("native streamer not built")
    srv = Server(async_port=0, data_port=0, host="127.0.0.1",
                 use_native=use_native)
    srv.start()
    a_port, d_port = srv.ports
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            srv.serve_one(timeout=0.5)

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    try:
        for i in range(2):                  # full disconnect between runs
            conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                                    sync_port=d_port)
            try:
                cmd = _cmd(freq=20_000 * (i + 1))
                conn.send_params(cmd)
                fn = Uconn.Packets_to_file(conn, cmd,
                                           filename=f"reconn_{i}",
                                           progress=False)
                data = Ufiles.openH5file(fn)
                assert data.shape == (1, 1000)
                assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3), i
            finally:
                conn.close()
    finally:
        stop.set()
        srv.close()


def test_ninety_measurements_no_degradation(tmp_chdir):
    """The reference UHD server crashed after ~83 measurements (the
    disabled reset_usrp_host workaround, cpp/USRP_hardware_manager.cpp:
    8-52).  Run 90 back-to-back measurements on one connection and check
    the last ones are as correct as the first."""
    srv = Server(async_port=0, data_port=0, host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            srv.serve_one(timeout=0.2)

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)
    try:
        for i in range(90):
            cmd = _cmd(freq=1000 * (i % 37 + 1), samples=20_000)
            conn.send_params(cmd)
            fn = Uconn.Packets_to_file(conn, cmd, filename=f"m{i:03d}",
                                       progress=False)
            if i < 2 or i >= 85:
                data = Ufiles.openH5file(fn)
                assert data.shape == (1, 200), i
                assert np.allclose(np.abs(data[0, 8:]), 0.5,
                                   atol=2e-3), i
    finally:
        stop.set()
        conn.close()
        srv.close()


def test_server_dual_uses_lockstep_path(tmp_chdir, monkeypatch):
    """A server-driven dual (A+B) measurement must dispatch the
    lock-step DualFused program, not sequential frontends — TXRX must
    hand channel=None through to run_measurement (the fast paths all
    gate on `channel is None`)."""
    import gpu_sdr.engine.dual as dual_mod
    from gpu_sdr.params import ServerSettings
    from gpu_sdr.server.txrx import TXRX

    made = []
    orig = dual_mod.DualFused.__init__

    def spy(self, *a, **k):
        made.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(dual_mod.DualFused, "__init__", spy)
    cmd = _cmd(100_000)
    b = _cmd(-200_000, fe="B")
    cmd.B_TXRX = b.B_TXRX
    cmd.B_RX2 = b.B_RX2
    txrx = TXRX(ServerSettings(tcp_streaming=False, file_writing=True))
    txrx.set(cmd)
    txrx.start()
    assert txrx.wait(timeout=120)
    assert txrx.error is None
    assert made, "dual measurement did not take the DualFused path"


def test_server_death_mid_measure_raises_not_hangs(tmp_chdir):
    """If the server vanishes mid-measure, Packets_to_file must raise
    promptly instead of spinning on an empty queue forever (the RX
    threads flag error/EOM on an EOF that precedes the EOM)."""
    import time

    srv = Server(async_port=0, data_port=0, host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)
    try:
        # no measurement is ever started; killing the server must still
        # release a waiting consumer via the EOF path
        killer = threading.Timer(0.5, srv.close)
        killer.start()
        cmd = _cmd(freq=10_000)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            Uconn.Packets_to_file(conn, cmd, filename="dead_server",
                                  progress=False)
        assert time.monotonic() - t0 < 30
    finally:
        conn.close()
        try:
            srv.close()
        except Exception:
            pass
