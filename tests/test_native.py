"""Tests for the native C++ data-plane streamer (skipped when the shared
library has not been built: cmake -S native -B native/build &&
cmake --build native/build)."""

import threading

import numpy as np
import pytest

from gpu_sdr.server import native as native_mod

pytestmark = pytest.mark.skipif(not native_mod.available(),
                                reason="native library not built")


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_native_streamer_roundtrip():
    """Push packets through the C++ streamer, receive them with the Python
    client-side decoder, verify framing and payload integrity."""
    import socket

    from gpu_sdr.engine.sinks import PacketMeta
    from gpu_sdr.server import wire

    srv = native_mod.NativeSyncServer(port=0, slot_bytes=1 << 16,
                                      queue_len=32)
    try:
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        c.settimeout(5)
        rng = np.random.default_rng(0)
        sent = []
        for i in range(20):
            data = (rng.standard_normal(500) + 1j *
                    rng.standard_normal(500)).astype(np.complex64)
            meta = PacketMeta(usrp_number=0, front_end_code="A",
                              packet_number=i, length=500, errors=0,
                              channels=5)
            assert srv.push(meta, data)
            sent.append(data)
        for i in range(20):
            raw = wire.recv_exact(c, wire.HEADER_SIZE)
            meta = wire.decode_sync_header(raw)
            assert meta["packet_number"] == i
            assert meta["channels"] == 5
            assert meta["front_end_code"] == "A_RX2"
            payload = wire.recv_exact(c, 8 * meta["length"])
            got = np.frombuffer(payload, dtype=np.complex64)
            assert np.array_equal(got, sent[i])
        srv.flush()
        assert srv.stats["packets_sent"] == 20
        c.close()
    finally:
        srv.close()


def test_native_end_to_end_measurement(tmp_chdir):
    """Full TCP measurement with the native data plane serving packets."""
    from gpu_sdr.client import connections as Uconn
    from gpu_sdr.client import files as Ufiles
    from gpu_sdr.params import (AntennaParams, AntMode, UsrpParams,
                                WaveType)
    from gpu_sdr.server.main import Server

    srv = Server(async_port=0, data_port=0, host="127.0.0.1",
                 use_native=True)
    srv.start()
    a_port, d_port = srv.ports
    worker = threading.Thread(target=lambda: srv.serve_one(timeout=15),
                              daemon=True)
    worker.start()
    conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                            sync_port=d_port)
    try:
        cmd = UsrpParams()
        cmd.A_TXRX = AntennaParams(
            mode=AntMode.TX, rate=1_000_000, buffer_len=100_000,
            samples=200_000, freq=[100_000], ampl=[0.5],
            wave_type=[WaveType.TONES], delay=1.0)
        cmd.A_RX2 = AntennaParams(
            mode=AntMode.RX, rate=1_000_000, buffer_len=100_000,
            samples=200_000, decim=100, pf_average=4, freq=[100_000],
            wave_type=[WaveType.DIRECT], delay=1.0)
        conn.send_params(cmd)
        fn = Uconn.Packets_to_file(conn, cmd, filename="native_meas")
        worker.join(timeout=20)
        data = Ufiles.openH5file(fn)
        assert data.shape == (1, 2000)
        assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3)
    finally:
        conn.close()
        srv.close()
