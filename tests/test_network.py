"""Integration tests of the TCP wire protocol: in-process server + client
run a full measurement over sockets and produce the same data as the
in-process path (the reference's client<->server round trip)."""

import threading
import time

import numpy as np
import pytest

from gpu_sdr.client import connections as Uconn
from gpu_sdr.client import files as Ufiles
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType
from gpu_sdr.server import wire
from gpu_sdr.server.main import Server


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_wire_sync_roundtrip():
    data = (np.arange(10) + 1j * np.arange(10)).astype(np.complex64)
    buf = wire.encode_sync_packet(0, b"B", 7, 2, 5, data)
    assert len(buf) == wire.HEADER_SIZE + 80
    meta = wire.decode_sync_header(buf[:wire.HEADER_SIZE])
    assert meta == {"usrp_number": 0, "front_end_code": "A_RX2",
                    "packet_number": 7, "length": 10, "errors": 2,
                    "channels": 5}
    back = np.frombuffer(buf[wire.HEADER_SIZE:], dtype=np.complex64)
    assert np.array_equal(back, data)


def test_wire_async_roundtrip():
    msg = wire.encode_async_message('{"a": 1}')
    assert wire.decode_async_header(msg[:8]) == 8
    assert msg[8:] == b'{"a": 1}'


def _direct_command(rate=1_000_000, samples=300_000):
    freqs = [100_000, -200_000]
    cmd = UsrpParams(usrp_number=0)
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=100_000, samples=samples,
        freq=freqs, ampl=[0.4, 0.4], wave_type=[WaveType.TONES] * 2,
        delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=samples,
        decim=100, pf_average=4, freq=freqs,
        wave_type=[WaveType.DIRECT] * 2, delay=1.0)
    return cmd


def test_tcp_end_to_end_measurement(tmp_chdir):
    """Server + client over real sockets: send a DIRECT-mode command, stream
    the demodulated packets back, write the H5 file, check the physics."""
    srv = Server(async_port=0, data_port=0, file_writing=False,
                 host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    worker = threading.Thread(target=lambda: srv.serve_one(timeout=15),
                              daemon=True)
    worker.start()

    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)
    try:
        cmd = _direct_command()
        conn.send_params(cmd)
        fn = Uconn.Packets_to_file(conn, cmd, filename="tcp_meas")
        worker.join(timeout=20)
        data = Ufiles.openH5file(fn)
        assert data.shape[0] == 2
        assert data.shape[1] == 300_000 // 100
        steady = data[:, 8:]
        assert np.allclose(np.abs(steady[0]), 0.4, atol=2e-3)
        assert np.allclose(np.abs(steady[1]), 0.4, atol=2e-3)
    finally:
        conn.close()
        srv.close()


def test_tcp_nack_on_bad_command(tmp_chdir):
    srv = Server(async_port=0, data_port=0, host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    worker = threading.Thread(target=lambda: srv.serve_one(timeout=15),
                              daemon=True)
    worker.start()
    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)
    try:
        # out-of-Nyquist tone -> server must nack and set error status
        bad = _direct_command()
        bad.A_RX2.wave_type = [WaveType.TONES] * 2
        bad.A_RX2.freq = [5_000_000, 0]
        bad.A_RX2.fft_tones = 16
        conn.send_params(bad)
        assert conn.end_of_measure.wait(timeout=10)
        assert conn.error_status.is_set()
    finally:
        conn.close()
        srv.close()


def test_pyusrp_style_global_api(tmp_chdir):
    """Connect()/Async_send()/Disconnect() module-level mirror."""
    srv = Server(async_port=0, data_port=0, host="127.0.0.1")
    srv.start()
    a_port, d_port = srv.ports
    worker = threading.Thread(target=lambda: srv.serve_one(timeout=15),
                              daemon=True)
    worker.start()
    try:
        assert Uconn.Connect(host="127.0.0.1", async_port=a_port,
                             sync_port=d_port)
        cmd = _direct_command(samples=100_000)
        conn = Uconn.get_connection()
        conn.send_params(cmd)
        fn = Uconn.Packets_to_file(conn, cmd, filename="tcp_meas2")
        data = Ufiles.openH5file(fn)
        assert data.shape[1] == 100_000 // 100
    finally:
        Uconn.Disconnect()
        srv.close()
