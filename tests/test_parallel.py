"""Multi-device sharding tests on the virtual 8-device CPU mesh:
the sharded DDC must bit-match the single-device op, including halo
exchange across time shards and carry across blocks."""

import jax
import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.ops import cplx
from gpu_sdr.ops.ddc import DirectDDCConfig
from gpu_sdr.parallel import ShardedDDC, make_mesh

RNG = np.random.default_rng(42)


def golden_ref(freqs, rate, decim, pfa, blocks):
    gold = golden.GoldenDirectDemodulator(freqs, rate, decim, pfa)
    return np.concatenate([gold(b) for b in blocks], axis=1).T  # (rows, C)


@pytest.mark.parametrize("mesh_shape,axes", [
    ((2, 4), ("time", "channels")),
    ((4, 2), ("time", "channels")),
    ((8,), ("channels",)),
    ((8, 1), ("time", "channels")),
])
def test_sharded_ddc_matches_golden(mesh_shape, axes):
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    rate, decim, pfa = 1_000_000, 10, 4
    freqs = tuple(int(f) for f in np.linspace(-400_000, 400_000, 8))
    L = 80_000
    cfg = DirectDDCConfig(rate=rate, decim=decim, pf_average=pfa,
                          freqs=freqs, phases=(0,) * 8)
    mesh = make_mesh(mesh_shape, axes)
    sd = ShardedDDC(cfg, mesh, L)
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L))
              .astype(np.complex64) for _ in range(3)]
    state = sd.init_state()
    outs = []
    for b in blocks:
        state, y = sd.step(state, sd.shard_input(b))
        outs.append(cplx.to_np(y))
    out = np.concatenate(outs, axis=0)
    ref = golden_ref(list(freqs), rate, decim, pfa, blocks)
    assert out.shape == ref.shape
    snr = golden.snr_db(ref, out)
    assert snr > 90.0, f"SNR {snr:.1f} dB (mesh {mesh_shape})"


def test_sharded_matches_single_device():
    """Sharded and unsharded paths must agree to float tolerance."""
    from gpu_sdr.ops.ddc import (ddc_carrier_init, ddc_carrier_step,
                                 direct_ddc_fir)
    rate, decim, pfa = 500_000, 5, 3
    freqs = tuple(int(f) for f in np.linspace(-200_000, 200_000, 4))
    L = 50_000
    cfg = DirectDDCConfig(rate=rate, decim=decim, pf_average=pfa,
                          freqs=freqs, phases=(0,) * 4)
    mesh = make_mesh((2, 2), ("time", "channels"))
    sd = ShardedDDC(cfg, mesh, L)
    x = (RNG.standard_normal(L) + 1j * RNG.standard_normal(L)
         ).astype(np.complex64)

    state = sd.init_state()
    _, y_sh = sd.step(state, sd.shard_input(x))

    hmod = cfg.modulated_taps()
    ramp = cfg.carrier_ramp(L // decim)
    stepv = ddc_carrier_step(cfg, L)
    phase = ddc_carrier_init(cfg, L)
    hist = cplx.zeros((pfa - 1) * decim)
    _, _, y1 = direct_ddc_fir(hmod, ramp, stepv, rate, decim, pfa,
                              phase, hist, cplx.from_np(x))
    a, b = cplx.to_np(y_sh), cplx.to_np(y1)
    assert golden.snr_db(b, a) > 110.0


def test_sharded_ddc_cross_block_carry_matches_golden():
    """Five blocks through a (4, 2) mesh with an off-grid tone set:
    ppermute halos and the cross-block carry hold golden parity."""
    rate, decim, pfa = 1_000_000, 20, 4
    freqs = (12_345, -67_891, 300_001, -299_999)
    L = 80_000
    cfg = DirectDDCConfig(rate=rate, decim=decim, pf_average=pfa,
                          freqs=freqs, phases=(0,) * 4)
    mesh = make_mesh((4, 2), ("time", "channels"))
    sd = ShardedDDC(cfg, mesh, L)
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L))
              .astype(np.complex64) for _ in range(5)]
    state = sd.init_state()
    outs = []
    for b in blocks:
        state, y = sd.step(state, sd.shard_input(b))
        outs.append(cplx.to_np(y))
    out = np.concatenate(outs, axis=0)
    ref = golden_ref(list(freqs), rate, decim, pfa, blocks)
    snr = golden.snr_db(ref, out)
    assert snr > 90.0, f"SNR {snr:.1f} dB"


def test_sharded_ddc_long_fir_matches_golden():
    """A long FIR (pf_average 10: a 9-row halo per time shard) keeps
    golden parity across shards and blocks."""
    rate, decim, pfa = 1_000_000, 10, 10
    freqs = tuple(int(f) for f in np.linspace(-400_000, 400_000, 8))
    L = 80_000
    cfg = DirectDDCConfig(rate=rate, decim=decim, pf_average=pfa,
                          freqs=freqs, phases=(0,) * 8)
    mesh = make_mesh((2, 4), ("time", "channels"))
    sd = ShardedDDC(cfg, mesh, L)
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L))
              .astype(np.complex64) for _ in range(2)]
    state = sd.init_state()
    outs = []
    for b in blocks:
        state, y = sd.step(state, sd.shard_input(b))
        outs.append(cplx.to_np(y))
    out = np.concatenate(outs, axis=0)
    ref = golden_ref(list(freqs), rate, decim, pfa, blocks)
    assert golden.snr_db(ref, out) > 90.0
