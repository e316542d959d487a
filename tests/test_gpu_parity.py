"""Card tier: each plain path that stands where a hand-written kernel
stood, at production widths, against the float64 oracles — the checks
chip_smoke.py runs in its phase P3.  Needs an NVIDIA GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_parity.py

Elsewhere every case skips (decided in the fixture, never at import)."""

import pytest

from gpu_sdr import parity

NAMES = [name for name, _ in parity.production_checks()]


@pytest.fixture
def card():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU, JAX has {dev.platform}")
    from gpu_sdr.config import configure_precision
    configure_precision()
    return dev


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_plain_path_parity_on_card(card, name):
    r = dict(parity.production_checks())[name]()
    assert r.snr_db >= 90.0, r
