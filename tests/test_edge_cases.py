"""Edge-case coverage: degenerate parameters that must still work."""

import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.ops import cplx
from gpu_sdr.ops.chirp import ChirpConfig, chirp_block
from gpu_sdr.ops.pfb import PFBConfig, pfb_frames, pfb_spare_init

RNG = np.random.default_rng(77)


def test_pfb_no_overlap_avg1():
    """pf_average=1: no spare carry, plain framed FFT."""
    x = (RNG.standard_normal(64 * 32) + 1j * RNG.standard_normal(64 * 32)
         ).astype(np.complex64)
    cfg = PFBConfig(nfft=64, avg=1, rate=64_000)
    sp = pfb_spare_init(cfg)
    assert sp.shape == (0,)
    sp, fr = pfb_frames(cfg, cfg.window(), cfg.dft(), sp, cplx.from_np(x))
    ref = golden.pfb_frames(x, 64, 1)
    assert golden.snr_db(ref, cplx.to_np(fr)) > 100


def test_chirp_single_step_is_tone():
    """num_steps=1 degenerates to a single tone (reference warns but
    proceeds, cpp/USRP_demodulator.cpp:197-199)."""
    cfg = ChirpConfig.from_params(100_000, 100_000, 1_000_000, 1, 0.01)
    assert cfg.num_steps == 1
    _, x = chirp_block(cfg, np.uint32(0), 5000)
    xn = cplx.to_np(x)
    # constant-frequency tone: unit modulus, uniform phase increment
    assert np.allclose(np.abs(xn), 1.0, atol=1e-5)
    dph = np.angle(xn[1:] / xn[:-1])
    assert np.std(dph) < 1e-3


def test_block_shorter_than_period_wraps():
    """Blocks longer than the chirp period wrap the accumulator exactly."""
    cfg = ChirpConfig.from_params(0, 100_000, 1_000_000, 10, 0.001)
    assert cfg.period == 1000
    _, x = chirp_block(cfg, np.uint32(0), 3500)   # 3.5 periods
    xn = cplx.to_np(x)
    assert np.allclose(xn[:1000], xn[1000:2000], atol=1e-6)
    assert np.allclose(xn[:500], xn[3000:3500], atol=1e-6)


def test_direct_single_channel():
    from gpu_sdr.engine import make_demodulator
    from gpu_sdr.params import AntennaParams, AntMode, WaveType
    p = AntennaParams(mode=AntMode.RX, rate=1_000_000, decim=1,
                      pf_average=1, buffer_len=50_000, samples=50_000,
                      freq=[0], wave_type=[WaveType.DIRECT])
    d = make_demodulator(p)
    x = np.ones(d.plan.block_len, dtype=np.complex64)
    out = d.run([x])
    # freq=0, decim=1: identity passthrough
    assert np.allclose(out[:, 0], 1.0, atol=1e-5)
