"""Sharded NOISE mode with frame-averaging decimation matches the
single-device demodulator."""

import numpy as np

from gpu_sdr.engine import make_demodulator
from gpu_sdr.ops import cplx
from gpu_sdr.parallel import make_mesh
from gpu_sdr.params import AntennaParams, AntMode, WaveType
from gpu_sdr import golden


def test_sharded_noise_decim_matches_single():
    rng = np.random.default_rng(31)
    p = AntennaParams(mode=AntMode.RX, rate=1_024_000, fft_tones=64,
                      pf_average=4, decim=4, buffer_len=64_000,
                      samples=128_000, freq=[0],
                      wave_type=[WaveType.NOISE])
    mesh = make_mesh((2, 4), ("time", "channels"))
    d_sh = make_demodulator(p, mesh=mesh)
    d_1 = make_demodulator(p)
    # both planners must agree enough to compare streams
    L = d_sh.plan.block_len
    blocks = [(rng.standard_normal(L) + 1j * rng.standard_normal(L)
               ).astype(np.complex64) for _ in range(2)]

    s_sh, s_1 = d_sh.init_state(), d_1.init_state()
    out_sh, out_1 = [], []
    for b in blocks:
        s_sh, y = d_sh.step(s_sh, cplx.from_np(b))
        out_sh.append(cplx.to_np(y))
    # single-device demod may use a different block length; feed the same
    # stream re-blocked
    stream = np.concatenate(blocks)
    L1 = d_1.plan.block_len
    for i in range(len(stream) // L1):
        s_1, y = d_1.step(s_1, cplx.from_np(stream[i * L1:(i + 1) * L1]))
        out_1.append(cplx.to_np(y))
    a = np.concatenate(out_sh, axis=0)
    b_ = np.concatenate(out_1, axis=0)
    n = min(len(a), len(b_))
    assert n > 0
    snr = golden.snr_db(b_[:n], a[:n])
    assert snr > 90, snr


def test_sharded_tones_block_not_inflated():
    """The sharded TONES plan must not square the decim factor into the
    block constraint (regression: nfft=1000, decim=100 under a T=2 mesh
    demanded 20M-sample blocks instead of ~buffer_len)."""
    from gpu_sdr.engine import make_demodulator
    from gpu_sdr.parallel import make_mesh
    from gpu_sdr.params import AntennaParams, AntMode, WaveType
    mesh = make_mesh((2, 4), ("time", "channels"))
    rate = 100_000_000
    bin_hz = rate // 1000
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=1_000_000,
                       samples=2_000_000, fft_tones=1000, pf_average=4,
                       decim=100, freq=[5 * bin_hz, -40 * bin_hz],
                       wave_type=[WaveType.TONES] * 2)
    d = make_demodulator(rx, mesh=mesh)
    q = 1000 * 100 * 2           # nfft * decim * time shards
    assert d.plan.block_len % q == 0
    assert d.plan.block_len <= 1_200_000, d.plan.block_len
