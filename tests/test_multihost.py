"""Multi-process (multi-host) rehearsal: N OS processes, 4 virtual CPU
devices each, joined by jax.distributed into one cluster; the sharded
chains run across all of them and every process checks its addressable
output shards against the float64 oracle (tools/multihost_rehearsal.py:
fused chain, lock-step dual config-5, all sharded mode families, mixed
modes, mesh-dispatched replay).

(The reference is strictly single-node — SURVEY.md section 2.4; this is
the jax.distributed path a real multi-host deployment uses.)
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tools", "multihost_rehearsal.py")

PHASE_KEYS = ('"ok": true', '"config5_lockstep": true',
              '"config5_aligned": true', '"config5_ok": true',
              '"phase3_ok": true', '"phase4_ok": true',
              '"phase5_ok": true', '"phase6_ok": true')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rehearsal(n_procs: int, mesh: str, timeout: float):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # script sets its own device count
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, SCRIPT, "--coordinator", f"localhost:{port}",
         "--num_processes", str(n_procs), "--process_id", str(i),
         "--mesh", mesh],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n_procs)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        for key in PHASE_KEYS:
            assert key in out, f"process {i} missing {key}:\n{out[-3000:]}"


def test_two_process_sharded_chain_matches_golden():
    # no pytest-timeout in this image; the communicate timeout below is
    # the real watchdog
    _run_rehearsal(2, "2x4", timeout=300)


@pytest.mark.parametrize("mesh", ["4x4", "2x8"])
def test_four_process_rehearsal(mesh):
    """4 processes x 4 devices: the 16-device cluster in both mesh
    geometries, all five phases (fused chain golden, lock-step dual
    config-5 alignment, sharded families at the 90 dB bar, mixed modes,
    cross-process replay)."""
    _run_rehearsal(4, mesh, timeout=600)
