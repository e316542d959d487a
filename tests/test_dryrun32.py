"""dryrun_multichip on a 32-device virtual mesh (the driver exercises 8,
test_dryrun16 guards 16; this guards the wide geometry: 2x16
(time, channels) with all eight sharded program families incl. the
mesh-dispatched replay and the lock-step dual frontends)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_32_devices():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    code = ("import __graft_entry__ as g; g.dryrun_multichip(32); "
            "print('DRYRUN32_OK')")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "DRYRUN32_OK" in p.stdout
