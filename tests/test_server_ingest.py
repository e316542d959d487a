"""Host-fed ingest through the full server round trip: client sends the
command, the server binds the native ingest receiver and announces its
port in an ack, an external producer streams raw complex64 IQ to it, and
the demodulated packets come back over the data plane — the live-radio
deployment shape (reference single_rx_thread feeding rx_single_link,
cpp/USRP_hardware_manager.cpp:1398-1611)."""

import socket
import threading
import time

import numpy as np
import pytest

from gpu_sdr.client import connections as Uconn
from gpu_sdr.client import files as Ufiles
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType
from gpu_sdr.server import native
from gpu_sdr.server.main import Server

pytestmark = pytest.mark.skipif(not native.ingest_available(),
                                reason="native ingest library not built")


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_ingest_measurement_over_server(tmp_chdir):
    rate = 1_000_000
    samples = 400_000
    cmd = UsrpParams()
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=samples,
        decim=100, pf_average=4, freq=[100_000],
        wave_type=[WaveType.DIRECT])

    srv = Server(async_port=0, data_port=0, host="127.0.0.1",
                 ingest_port=0)
    srv.start()
    a_port, d_port = srv.ports
    worker = threading.Thread(target=lambda: srv.serve_one(timeout=30),
                              daemon=True)
    worker.start()
    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)

    t = np.arange(samples)
    iq = (0.4 * np.exp(2j * np.pi * 100_000 * t / rate)
          ).astype(np.complex64)

    def produce():
        deadline = time.monotonic() + 20
        while conn.ingest_port is None:
            if time.monotonic() > deadline:
                return
            time.sleep(0.01)
        with socket.create_connection(("127.0.0.1",
                                       conn.ingest_port)) as s:
            s.sendall(iq.tobytes())

    producer = threading.Thread(target=produce, daemon=True)
    try:
        conn.send_params(cmd)
        producer.start()
        fn = Uconn.Packets_to_file(conn, cmd, filename="ingest_meas",
                                   progress=False)
        producer.join(timeout=10)
        data = Ufiles.openH5file(fn)
        assert data.shape == (1, samples // 100)
        assert np.allclose(np.abs(data[0, 8:]), 0.4, atol=2e-3)
        assert conn.ingest_port is not None
    finally:
        conn.close()
        srv.close()
