"""Sharded TONES (channelizer + tone select) matches the single-device
demodulator, with and without frame-averaging decimation."""

import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.engine import make_demodulator
from gpu_sdr.ops import cplx
from gpu_sdr.parallel import make_mesh
from gpu_sdr.params import AntennaParams, AntMode, WaveType

RNG = np.random.default_rng(47)


@pytest.mark.parametrize("decim", [0, 4])
def test_sharded_tones_matches_single(decim):
    rate, nfft = 1_024_000, 64
    bin_hz = rate // nfft
    freqs = [5 * bin_hz, -10 * bin_hz, 20 * bin_hz]
    p = AntennaParams(mode=AntMode.RX, rate=rate, fft_tones=nfft,
                      pf_average=4, decim=decim, buffer_len=64_000,
                      samples=128_000, freq=freqs,
                      wave_type=[WaveType.TONES] * 3)
    mesh = make_mesh((2, 4), ("time", "channels"))
    d_sh = make_demodulator(p, mesh=mesh)
    d_1 = make_demodulator(p)
    assert d_sh.n_channels == 3

    L = d_sh.plan.block_len
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L)
               ).astype(np.complex64) for _ in range(2)]
    s = d_sh.init_state()
    out_sh = []
    for b in blocks:
        s, y = d_sh.step(s, cplx.from_np(b))
        out_sh.append(cplx.to_np(y))
    stream = np.concatenate(blocks)
    L1 = d_1.plan.block_len
    s1 = d_1.init_state()
    out_1 = []
    for i in range(len(stream) // L1):
        s1, y = d_1.step(s1, cplx.from_np(stream[i * L1:(i + 1) * L1]))
        out_1.append(cplx.to_np(y))
    a = np.concatenate(out_sh, axis=0)
    b_ = np.concatenate(out_1, axis=0)
    n = min(len(a), len(b_))
    assert n > 0
    assert golden.snr_db(b_[:n], a[:n]) > 90
