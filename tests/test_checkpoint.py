"""Checkpoint/resume of streaming state: stop after k blocks, reload, and
the continuation must be bit-identical to an uninterrupted run."""

import numpy as np
import pytest

from gpu_sdr.engine import make_demodulator
from gpu_sdr.engine.checkpoint import load_state, save_state
from gpu_sdr.ops import cplx
from gpu_sdr.params import AntennaParams, AntMode, WaveType

RNG = np.random.default_rng(21)


def crandn(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
            ).astype(np.complex64)


@pytest.mark.parametrize("wave,extra", [
    (WaveType.DIRECT, dict(decim=50, pf_average=4, freq=[12_345, -200_000],
                           buffer_len=50_000)),
    (WaveType.TONES, dict(fft_tones=50, pf_average=4, freq=[100_000],
                          buffer_len=50_000)),
    (WaveType.CHIRP, dict(decim=1, freq=[-200_000], chirp_f=[200_000],
                          chirp_t=[0.05], swipe_s=[500],
                          buffer_len=50_000)),
])
def test_checkpoint_resume_bit_identical(tmp_path, wave, extra):
    n_ch = len(extra["freq"])
    p = AntennaParams(mode=AntMode.RX, rate=1_000_000, samples=400_000,
                      wave_type=[wave] * n_ch, **extra)
    demod = make_demodulator(p)
    L = demod.plan.block_len
    blocks = [crandn(L) for _ in range(4)]

    # uninterrupted run
    state = demod.init_state()
    ref = []
    for b in blocks:
        state, y = demod.step(state, cplx.from_np(b))
        ref.append(cplx.to_np(y))

    # run 2 blocks, checkpoint, reload, continue
    state = demod.init_state()
    for b in blocks[:2]:
        state, y = demod.step(state, cplx.from_np(b))
    ckpt = str(tmp_path / "carry")
    save_state(state, ckpt, block_index=2)
    state2, k = load_state(ckpt, like=demod.init_state())
    assert k == 2
    out = []
    for b in blocks[2:]:
        state2, y = demod.step(state2, cplx.from_np(b))
        out.append(cplx.to_np(y))

    for a, b_ in zip(ref[2:], out):
        assert np.array_equal(a, b_), "resumed stream differs"


def test_checkpoint_config_mismatch(tmp_path):
    p1 = AntennaParams(mode=AntMode.RX, rate=1_000_000, samples=100_000,
                       decim=50, pf_average=4, freq=[1000],
                       wave_type=[WaveType.DIRECT], buffer_len=50_000)
    d1 = make_demodulator(p1)
    s = d1.init_state()
    save_state(s, str(tmp_path / "c1"))
    p2 = AntennaParams(mode=AntMode.RX, rate=1_000_000, samples=100_000,
                       decim=50, pf_average=8, freq=[1000],
                       wave_type=[WaveType.DIRECT], buffer_len=50_000)
    d2 = make_demodulator(p2)
    with pytest.raises(ValueError):
        load_state(str(tmp_path / "c1"), like=d2.init_state())
