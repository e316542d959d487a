"""Utilities: logging format, StopWatch, pretty-printer, log viewer tool."""

import logging
import os
import re
import subprocess
import sys
import time

from gpu_sdr.utils.diagnostics import StopWatch, ThroughputMeter, print_params
from gpu_sdr.utils.log import get_logger, set_this_thread_name
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stopwatch_cycles():
    sw = StopWatch()
    for _ in range(3):
        sw.start()
        time.sleep(0.01)
        sw.store()
    assert len(sw.history) == 3
    assert 0.005 < sw.get_average() < 0.1


def test_throughput_meter():
    tm = ThroughputMeter()
    tm.add(1000)
    tm.add(1000)
    assert tm.blocks == 2
    assert tm.msps > 0


def test_print_params_lists_active_antennas(capsys):
    p = UsrpParams()
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1_000_000, freq=[1000],
                            wave_type=[WaveType.DIRECT], decim=10)
    text = print_params(p)
    assert "A_RX2" in text and "DIRECT" in text
    assert "B_RX2" not in text


def test_log_record_format(tmp_path, monkeypatch):
    """Record format matches the reference:
    TimeStamp;ThreadName;Severity;Message."""
    import importlib
    import gpu_sdr.utils.log as L
    monkeypatch.chdir(tmp_path)
    importlib.reload(L)
    L.init_logger(log_dir=str(tmp_path / "logs"))
    L.set_this_thread_name("test_thread")
    L.get_logger("unit").warning("hello world")
    logging.getLogger("gpu_sdr").handlers[0].flush()
    logs = list((tmp_path / "logs").glob("*.log"))
    assert logs
    line = logs[0].read_text().strip().splitlines()[-1]
    parts = line.split(";", 3)
    assert len(parts) == 4
    assert parts[1] == "test_thread"
    assert parts[2] == "WARNING"
    assert parts[3] == "hello world"

    # and the HTML viewer renders it
    out = tmp_path / "log.html"
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "read_server_log.py"),
         "--log", str(logs[0]), "--out", str(out)],
        capture_output=True, text=True, timeout=30)
    assert p.returncode == 0, p.stderr
    assert "hello world" in out.read_text()
