"""End-to-end host-fed science loop across THREE OS processes — the
reference's full deployment stack (SURVEY sections 3.1-3.5):

  [producer process]  tools/science_producer.py — synthesizes the VNA
                      chirp, filters it through two simulated resonators,
                      streams raw IQ over TCP into the server's ingest
  [server process]    gpu_sdr.server.main --ingest: JSON command ->
                      ack announcing the ingest port -> CHIRP demod ->
                      data plane TCP -> EOM
  [client = this test] Connection + Packets_to_file -> reference-layout
                      H5 -> VNA_analysis -> initialize_peaks -> vna_fit
                      recovers the planted resonators

(reference call stack: cpp/usrp_server.cpp:75-108 driving
pyUSRP/USRP_VNA.py:276-445 + USRP_fitting.py:380-715)
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from gpu_sdr.server import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCER = os.path.join(REPO, "tools", "science_producer.py")

pytestmark = pytest.mark.skipif(not native.ingest_available(),
                                reason="native ingest library not built")

RATE = 1_000_000
RESOS = [dict(f0=-150_000.0, Qr=30.0, Qe_re=60.0),
         dict(f0=200_000.0, Qr=25.0, Qe_re=50.0)]


def _spawn_server():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "from gpu_sdr.server.main import main; import sys; "
            "sys.exit(main(['--async_port', '0', '--data_port', '0', "
            "'--ingest', '0', '--one_shot']))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # parse "gpu_sdr server ready: async port A, data port D"
    deadline = time.monotonic() + 120
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if "server ready" in line:
            break
        if proc.poll() is not None:
            raise RuntimeError(f"server died: {line}")
    parts = line.replace(",", "").split()
    a_port = int(parts[parts.index("async") + 2])
    d_port = int(parts[parts.index("data") + 2])
    return proc, a_port, d_port


def test_science_loop_three_processes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from gpu_sdr.client import connections as Uconn
    from gpu_sdr.client import delay as Udelay
    from gpu_sdr.client import files as Ufiles
    from gpu_sdr.client import fitting as Ufit
    from gpu_sdr.client import vna as Uvna

    server = producer = None
    conn = None
    # the resonator channel's causal FIR shift: fft_len/8 samples
    Udelay.set_line_delay(RATE, 512e-6 * 1e9)
    try:
        server, a_port, d_port = _spawn_server()
        cmd = Uvna.compose_vna_command(
            start_f=-400_000, last_f=400_000, measure_t=0.4,
            n_points=1600, tx_gain=0, Rate=RATE, RF=10_000_000)
        cmd_path = tmp_path / "cmd.json"
        cmd_path.write_text(cmd.to_json())
        portfile = tmp_path / "ingest_port.txt"
        producer = subprocess.Popen(
            [sys.executable, PRODUCER, "--params", str(cmd_path),
             "--portfile", str(portfile),
             "--resonators", json.dumps(RESOS),
             "--fft_len", str(1 << 12)],
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                                sync_port=d_port)
        conn.send_params(cmd)
        deadline = time.monotonic() + 60
        while conn.ingest_port is None:
            assert time.monotonic() < deadline, "no ingest port announced"
            time.sleep(0.02)
        portfile.write_text(str(conn.ingest_port))

        fn = Uconn.Packets_to_file(conn, cmd, filename="science_vna",
                                   meas_type="VNA", progress=False)
        out, _ = producer.communicate(timeout=120)
        assert producer.returncode == 0, out[-2000:]
        assert "producer done" in out
    finally:
        Udelay.LINE_DELAY.clear()
        if conn is not None:
            conn.close()
        for p in (producer, server):
            if p is not None and p.poll() is None:
                p.kill()

    # the science layer on the streamed file
    Uvna.VNA_analysis(fn)
    assert Ufiles.is_VNA_analyzed(fn)
    ok = Ufit.initialize_peaks(fn, N_peaks=2, peak_width=50e3,
                               Qr_cutoff=5, Mag_depth_cutoff=0.5,
                               exclude_center=False)
    assert ok
    assert len(Ufiles.get_init_peaks(fn)) == 2
    assert Ufit.vna_fit(fn, fit_range=60e3)
    params = Ufit.get_fit_param(fn)
    assert len(params) == 2
    f0s = sorted(1e6 * p["f0"] for p in params)
    expect = sorted(10_000_000 + r["f0"] for r in RESOS)
    for got, exp in zip(f0s, expect):
        assert abs(got - exp) < 10_000, (got, exp)
    for p in params:
        assert np.isfinite(p["Qr"]) and p["Qr"] > 0
