"""Parity tests: fused DDC+FIR op vs the golden reference model
(direct_demodulator_integer + FIR, cpp/kernels.cu:45-86 + cpp/fir.cu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.ops import cplx
from gpu_sdr.ops.ddc import (
    DirectDDCConfig, ddc_carrier_init, ddc_carrier_step, direct_ddc_fir)
from gpu_sdr.ops.fir import fir_init_state, fir_taps_direct, streaming_fir

RNG = np.random.default_rng(1234)


def run_blocks(cfg: DirectDDCConfig, x_blocks):
    L = len(x_blocks[0])
    nb = L // cfg.M
    hmod = cfg.modulated_taps()
    ramp = cfg.carrier_ramp(nb)
    step = ddc_carrier_step(cfg, L)
    phase = ddc_carrier_init(cfg, L)
    hist = cplx.zeros((cfg.f - 1) * cfg.M)
    fn = jax.jit(lambda p, h, x: direct_ddc_fir(
        hmod, ramp, step, cfg.rate, cfg.M, cfg.f, p, h, x))
    outs = []
    for xb in x_blocks:
        phase, hist, y = fn(phase, hist, cplx.from_np(xb))
        outs.append(cplx.to_np(y).T)         # -> (C, nb)
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("decim,pf_average", [(10, 4), (25, 8), (100, 2)])
def test_ddc_fir_matches_golden(decim, pf_average):
    rate = 1_000_000
    L = 20_000
    freqs = [12_345, -67_890, 250_000]
    cfg = DirectDDCConfig(rate=rate, decim=decim, pf_average=pf_average,
                          freqs=tuple(freqs), phases=(0,) * len(freqs))
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L))
              .astype(np.complex64) for _ in range(4)]
    gold = golden.GoldenDirectDemodulator(freqs, rate, decim, pf_average)
    ref = np.concatenate([gold(b) for b in blocks], axis=1)
    out = run_blocks(cfg, blocks)
    assert out.shape == ref.shape
    snr = golden.snr_db(ref, out)
    assert snr > 90.0, f"SNR {snr:.1f} dB too low"


def test_ddc_no_decimation_matches_golden():
    rate = 100_000
    L = 10_000
    freqs = [1000, -2500]
    cfg = DirectDDCConfig(rate=rate, decim=0, pf_average=1,
                          freqs=tuple(freqs), phases=(0, 0))
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L))
              .astype(np.complex64) for _ in range(3)]
    gold = golden.GoldenDirectDemodulator(freqs, rate, 0, 1)
    ref = np.concatenate([gold(b) for b in blocks], axis=1)
    out = run_blocks(cfg, blocks)
    snr = golden.snr_db(ref, out)
    assert snr > 100.0


def test_ddc_tone_recovery():
    """Demodulating a pure tone at f_c must give a DC output of the tone
    amplitude (the physics sanity check)."""
    rate = 1_000_000
    L = 50_000
    f0 = 123_456
    decim, pf_average = 50, 4
    n = np.arange(3 * L, dtype=np.int64)
    x = 0.5 * np.exp(2j * np.pi * ((f0 * (n % rate)) % rate) / rate)
    x = x.astype(np.complex64)
    cfg = DirectDDCConfig(rate=rate, decim=decim, pf_average=pf_average,
                          freqs=(f0,), phases=(0,))
    out = run_blocks(cfg, [x[:L], x[L:2 * L], x[2 * L:]])
    # skip startup transient (f-1 outputs)
    steady = out[0, pf_average:]
    assert np.allclose(steady, 0.5, atol=1e-3)


def test_streaming_fir_matches_golden():
    M, f = 8, 5
    taps = fir_taps_direct(M, f, dtype=np.float64)
    L = 4000
    C_ = 3
    blocks = [(RNG.standard_normal((C_, L)) +
               1j * RNG.standard_normal((C_, L))).astype(np.complex64)
              for _ in range(3)]
    golds = [golden.GoldenFIR(taps, M, f) for _ in range(C_)]
    ref = np.concatenate(
        [np.stack([g(b[c]) for c, g in enumerate(golds)]) for b in blocks],
        axis=1)
    tj = jnp.asarray(taps.astype(np.float32))
    state = fir_init_state(C_, M, f)
    fn = jax.jit(lambda s, z: streaming_fir(tj, s, z))
    outs = []
    for b in blocks:
        state, y = fn(state, cplx.from_np(b))
        outs.append(cplx.to_np(y))
    out = np.concatenate(outs, axis=1)
    snr = golden.snr_db(ref, out)
    assert snr > 90.0
