"""End-to-end test of the real server CLI daemon: spawn
`python -m gpu_sdr.server.main` as a subprocess, connect over TCP, run
a measurement, and read the streamed results."""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from gpu_sdr.client import connections as Uconn
from gpu_sdr.client import files as Ufiles
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def test_server_cli_daemon(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from gpu_sdr.server.main import main;"
         "main(['--one_shot', '--async_port', '0', '--data_port', '0'])"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=ENV, cwd=tmp_path)
    try:
        # parse the announced ports
        line = ""
        t0 = time.time()
        while "server ready" not in line:
            line = proc.stdout.readline()
            assert time.time() - t0 < 60, "server did not start"
        m = re.search(r"async port (\d+), data port (\d+)", line)
        a_port, d_port = int(m.group(1)), int(m.group(2))

        conn = Uconn.Connection(host="127.0.0.1", async_port=a_port,
                                sync_port=d_port)
        try:
            cmd = UsrpParams()
            cmd.A_TXRX = AntennaParams(
                mode=AntMode.TX, rate=1_000_000, buffer_len=100_000,
                samples=200_000, freq=[50_000], ampl=[0.5],
                wave_type=[WaveType.TONES], delay=1.0)
            cmd.A_RX2 = AntennaParams(
                mode=AntMode.RX, rate=1_000_000, buffer_len=100_000,
                samples=200_000, decim=100, pf_average=4, freq=[50_000],
                wave_type=[WaveType.DIRECT], delay=1.0)
            conn.send_params(cmd)
            fn = Uconn.Packets_to_file(conn, cmd,
                                       filename=str(tmp_path / "cli_meas"))
            data = Ufiles.openH5file(fn)
            assert data.shape == (1, 2000)
            assert np.allclose(np.abs(data[0, 8:]), 0.5, atol=2e-3)
        finally:
            conn.close()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_deriv_trigger_passes_glitchy_data():
    from gpu_sdr.client.triggers import deriv_test
    trig = deriv_test(threshold=1.1)
    n_chan, L = 2, 600
    rng = np.random.default_rng(0)
    base = np.ones(L * n_chan, dtype=np.complex64)
    md = {"channels": n_chan, "length": L * n_chan}
    # two quiet packets accumulate
    out, md1 = trig.trigger(base.copy(), dict(md))
    assert md1["length"] == 0
    out, md2 = trig.trigger(base.copy(), dict(md))
    assert md2["length"] == 0
    # third packet has a glitch -> all accumulated data released
    glitchy = base.copy()
    glitchy[100] += 50
    out, md3 = trig.trigger(glitchy, dict(md))
    assert md3["length"] == 3 * L * n_chan
    assert len(out) == 3 * L * n_chan
