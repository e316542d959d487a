"""Parity tests: the shift-fold TONES->DIRECT chain (ops/fold_chain.py)
vs the golden reference models (tone_gen cpp/kernels.cu:589-684 +
direct_demodulator_integer :45-86 + FIR cpp/fir.cu)."""

import numpy as np

from gpu_sdr import golden
from gpu_sdr.ops import cplx
from gpu_sdr.ops.ddc import DirectDDCConfig
from gpu_sdr.ops.fold_chain import TonesDirectFoldChain

RATE = 1_000_000
M, F = 20, 4
L = 8_000


def golden_loopback(freqs, ampls, rx_freqs, n_blocks):
    x = golden.tone_block(freqs, ampls, RATE, 0, n_blocks * L)
    g = golden.GoldenDirectDemodulator(rx_freqs, RATE, M, F)
    return np.concatenate(
        [g(x[k * L:(k + 1) * L]) for k in range(n_blocks)], axis=1)


def build_chain(freqs, ampls, rx_freqs):
    cfg = DirectDDCConfig(rate=RATE, decim=M, pf_average=F,
                          freqs=tuple(rx_freqs),
                          phases=(0,) * len(rx_freqs))
    ch = TonesDirectFoldChain(rate=RATE, tx_freqs=tuple(freqs),
                              tx_ampls=tuple(ampls), cfg=cfg, block_len=L)
    assert ch.ok
    return ch


def run_chain(ch, n_blocks, K):
    st = ch.init_state()
    outs = []
    for _ in range(n_blocks // K):
        st, y = ch.multi_step(st, K)
        outs.append(cplx.to_np(y).T)
    return np.concatenate(outs, axis=1)


def test_fold_chain_matches_golden_including_startup():
    """Non-periodic 24-tone comb: the fold chain must match the golden
    single-stage DIRECT chain on EVERY row, including the zero-history
    startup transient (restored by the partial-fold correction)."""
    freqs = [int(f) for f in np.linspace(-0.45 * RATE, 0.45 * RATE, 24)]
    ampls = [0.05] * len(freqs)
    ref = golden_loopback(freqs, ampls, freqs, 4)
    ch = build_chain(freqs, ampls, freqs)
    out = run_chain(ch, 4, K=2)
    assert out.shape == ref.shape
    snr = golden.snr_db(ref, out)
    assert snr > 90.0, f"SNR {snr:.1f} dB"
    # the startup rows specifically (the correction path)
    snr0 = golden.snr_db(ref[:, :F - 1], out[:, :F - 1])
    assert snr0 > 80.0, f"startup rows SNR {snr0:.1f} dB"


def test_fold_chain_distinct_rx_tones():
    """RX tones need not equal TX tones (guard channels)."""
    tx = [100_003, -200_001, 330_007]
    rx = [100_003, -200_001]
    ref = golden_loopback(tx, [0.3, 0.2, 0.1], rx, 2)
    ch = build_chain(tx, [0.3, 0.2, 0.1], rx)
    out = run_chain(ch, 2, K=1)
    assert golden.snr_db(ref, out) > 90.0


def test_fused_loopback_dispatches_fold_chain():
    """A non-periodic comb through the public FusedLoopback must ride
    the fold chain and still match the golden end-to-end."""
    from gpu_sdr.engine.fused import FusedLoopback
    from gpu_sdr.params import AntennaParams, AntMode, WaveType

    freqs = [int(f) for f in np.linspace(-0.4 * RATE, 0.4 * RATE, 17)]
    ampls = [0.1] * len(freqs)
    tx = AntennaParams(mode=AntMode.TX, rate=RATE, buffer_len=L,
                       freq=freqs, ampl=ampls,
                       wave_type=[WaveType.TONES] * len(freqs))
    rx = AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=L,
                       decim=M, pf_average=F, freq=freqs,
                       wave_type=[WaveType.DIRECT] * len(freqs))
    fl = FusedLoopback(tx, rx, blocks_per_exec=2)
    assert isinstance(fl._chain, TonesDirectFoldChain)
    Lp = fl.demod.plan.block_len
    gstate, dstate = fl._init_states()
    gstate, dstate, ys = fl._multi(gstate, dstate)
    out = cplx.to_np(ys.reshape(-1, ys.re.shape[-1])).T
    x = golden.tone_block(freqs, ampls, RATE, 0, 2 * Lp)
    g = golden.GoldenDirectDemodulator(freqs, RATE, M, F)
    ref = np.concatenate([g(x[:Lp]), g(x[Lp:])], axis=1)
    assert golden.snr_db(ref, out) > 90.0


def test_fold_chain_state_survives_reuse():
    """init_state hands out copies: two acquisitions from one chain give
    identical streams (donation-safety contract)."""
    freqs = [123_457, -345_677]
    ch = build_chain(freqs, [0.5, 0.5], freqs)
    a = run_chain(ch, 2, K=2)
    b = run_chain(ch, 2, K=2)
    assert np.array_equal(a, b)
