"""The pieces of chip_smoke.py that run without a card: it refuses a CPU
device and a checkout without the package, its result line, the card
line, the phase report, the compile-cache placement and the matmul
precision it reports."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

import chip_smoke
from gpu_sdr import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", **kw)
    return env


def test_refuses_cpu_device():
    p = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "needs an NVIDIA GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_fails_without_the_package(tmp_path):
    """Alone in a directory (no gpu_sdr to import), every phase fails
    and no result line is printed, even past the device check."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    code = ("import chip_smoke as c; c.require_gpu = lambda jax: None; "
            "raise SystemExit(c.main([]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert "FAIL P0" in p.stdout
    assert '"ok"' not in p.stdout


def _fake_jax(platform, kind, count):
    dev = types.SimpleNamespace(platform=platform, device_kind=kind)
    return types.SimpleNamespace(devices=lambda: [dev] * count)


def test_result_line_shape():
    line = chip_smoke.result_line(_fake_jax("gpu", "NVIDIA H100 80GB HBM3",
                                            1))
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_require_gpu_rejects_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(_fake_jax("cpu", "cpu", 8))
    chip_smoke.require_gpu(_fake_jax("gpu", "NVIDIA H100", 1))


@pytest.mark.parametrize("stdout,rc,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", 0, "NVIDIA H100 80GB HBM3, 700.00 W"),
    ("a, 1 W\nb, 2 W\n", 0, "a, 1 W | b, 2 W"),
    ("", 9, "nvidia-smi failed (rc 9)"),
])
def test_card_line(monkeypatch, stdout, rc, want):
    def fake_run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        return subprocess.CompletedProcess(cmd, rc, stdout, "")
    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    assert chip_smoke.card_line().startswith(want)


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert chip_smoke.card_line().startswith("nvidia-smi unavailable")


def test_report_fails_below_bar(capsys):
    rep = chip_smoke.Report("card X")
    rep.line("P9 good", "shapes", 120.0, 1.0, 0.5)
    rep.line("P9 bad", "shapes", 80.0, 1.0, 0.5)
    rep.run("P9 raises", lambda r: 1 / 0)
    out = capsys.readouterr().out
    assert rep.failed == ["P9 bad", "P9 raises"]
    assert "P9 good | shapes | snr 120.0 dB | compile 1.00 s" in out
    assert out.count("card card X") == 2


def test_head_sink_keeps_head_counts_rows():
    s = chip_smoke.HeadSink(5)
    s.on_packet(None, np.ones((3, 2), np.complex64))
    s.on_packet(None, np.full((4, 2), np.nan, np.complex64))
    assert s.rows == 7 and s.head.shape == (5, 2) and not s.finite


@pytest.mark.parametrize("env", [None, "/somewhere/jax_cache"])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert config.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert config.compile_cache_dir() == env


@pytest.mark.parametrize("env,want", [
    (None, "float32"), ("BF16_BF16_F32_X3", "BF16_BF16_F32_X3")])
def test_matmul_precision_resolution(monkeypatch, env, want):
    monkeypatch.setattr(config, "_precision", None)
    if env is None:
        monkeypatch.delenv("GPU_SDR_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("GPU_SDR_MATMUL_PRECISION", env)
    assert config.matmul_precision() == want


def test_configure_precision_sets_jax_and_rejects_unknown(monkeypatch):
    import jax
    prev = jax.config.jax_default_matmul_precision
    monkeypatch.setattr(config, "_applied", False)
    monkeypatch.setattr(config, "_precision", None)
    monkeypatch.setattr(config, "enable_compile_cache", lambda: None)
    try:
        config.configure_precision("highest")
        assert jax.config.jax_default_matmul_precision == "highest"
        assert config.matmul_precision() == "highest"
        with pytest.raises(ValueError):
            config.configure_precision("not-a-precision", force=True)
    finally:
        jax.config.update("jax_default_matmul_precision", prev)


def test_main_path_runs_without_h5py():
    """The card's machine may lack h5py: the server, the client and
    run_measurement without a file import nothing that needs it."""
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import gpu_sdr.client.connections, gpu_sdr.client.vna\n"
        "import gpu_sdr.server.main\n"
        "import chip_smoke as c\n"
        "from gpu_sdr import measure\n"
        "cmd = c.direct_command(100_000, n_tones=2)\n"
        "s = c.HeadSink(10)\n"
        "measure.run_measurement(cmd, None, extra_sinks=[s])\n"
        "assert s.rows == c._expected_rows(cmd) and s.finite, s.rows\n"
        "print('NO_H5PY_OK')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "NO_H5PY_OK" in p.stdout
