"""Test configuration: an 8-device virtual CPU mesh by default.

Multi-chip sharding paths are validated on virtual CPU devices.  The
`gpu`-marked tier (tests/test_gpu_parity.py) runs on the card when
JAX_PLATFORMS names it, e.g.
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_parity.py``;
here those tests skip.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_report_header(config):
    return f"jax backend: {jax.default_backend()}, devices: {jax.device_count()}"


def pytest_configure(config):
    """The native C++ data plane must not silently self-exclude from a
    stock test run: if libsdr_native.so is missing, build it here
    (cmake is a cached no-op when already built); if the toolchain is
    present and the build fails, that is a loud error, not six silent
    skips of the hot-path components."""
    import shutil
    import subprocess

    import pytest

    from gpu_sdr.server import native as native_mod
    if native_mod.load_library() is not None:
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmake = shutil.which("cmake")
    if cmake is None:  # pragma: no cover - CI images always carry cmake
        raise pytest.UsageError(
            "native/build/libsdr_native.so is missing and cmake is not on "
            "PATH; build the native data plane first (see native/README "
            "or CLAUDE.md) — its tests must not be skipped silently")
    build = os.path.join(root, "native", "build")
    try:
        subprocess.run([cmake, "-S", os.path.join(root, "native"),
                        "-B", build],
                       check=True, capture_output=True, text=True)
        subprocess.run([cmake, "--build", build],
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:  # pragma: no cover
        raise pytest.UsageError(
            f"native build failed:\n{e.stdout}\n{e.stderr}")
    if native_mod.load_library() is None:  # pragma: no cover
        raise pytest.UsageError(
            "native build completed but libsdr_native.so did not load")
