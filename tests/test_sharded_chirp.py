"""Sharded CHIRP lock-in matches the single-device demodulator."""

import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.engine import make_demodulator
from gpu_sdr.ops import cplx
from gpu_sdr.parallel import make_mesh
from gpu_sdr.params import AntennaParams, AntMode, WaveType

RNG = np.random.default_rng(53)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (8, 1)])
def test_sharded_chirp_matches_single(mesh_shape):
    rate = 1_000_000
    p = AntennaParams(mode=AntMode.RX, rate=rate, decim=1,
                      buffer_len=100_000, samples=200_000,
                      freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
                      swipe_s=[1000], wave_type=[WaveType.CHIRP])
    mesh = make_mesh(mesh_shape, ("time", "channels"))
    d_sh = make_demodulator(p, mesh=mesh)
    d_1 = make_demodulator(p)

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
    assert golden.snr_db(b_[:n], a[:n]) > 100, mesh_shape


def test_sharded_chirp_flat_loopback():
    """Ideal loopback through the sharded path gives S21 = 1 exactly."""
    from gpu_sdr.engine import make_generator
    rate = 1_000_000
    p = dict(rate=rate, buffer_len=100_000, samples=100_000,
             freq=[-300_000], chirp_f=[300_000], chirp_t=[0.1],
             swipe_s=[1000])
    rx = AntennaParams(mode=AntMode.RX, decim=1,
                       wave_type=[WaveType.CHIRP], **p)
    tx = AntennaParams(mode=AntMode.TX, ampl=[1.0],
                       wave_type=[WaveType.CHIRP], **p)
    mesh = make_mesh((4, 2), ("time", "channels"))
    d = make_demodulator(rx, mesh=mesh)
    gen = make_generator(tx, block_len=d.plan.block_len)
    s = d.init_state()
    for x in gen.blocks(2):
        s, y = d.step(s, cplx.from_np(x))
    s21 = cplx.to_np(y)[:, 0]
    assert np.allclose(s21.real, 1.0, atol=1e-4)
    assert np.allclose(s21.imag, 0.0, atol=1e-4)
