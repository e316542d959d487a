"""dryrun_multichip on a 16-device virtual mesh (the driver exercises 8;
this guards the wider geometry: 2x8 (time, channels) with all six sharded
program families incl. the mesh-dispatched replay)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_16_devices():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    code = ("import __graft_entry__ as g; g.dryrun_multichip(16); "
            "print('DRYRUN16_OK')")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=500)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "DRYRUN16_OK" in p.stdout
