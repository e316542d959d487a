"""The plain XLA paths that stand where hand-written kernels stood, at the
geometries those kernels were tested at, against the float64 oracles:
the closed-form TONES->DIRECT fold chain, the DDC + decimating FIR, the
PFB pre-sum + DFT, the chirp lock-in and the resident replay scan."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_sdr import golden, parity
from gpu_sdr.engine.replay import DeviceReplay
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.ops import cplx
from gpu_sdr.ops.chirp import ChirpConfig, chirp_demod_block
from gpu_sdr.ops.ddc import (DirectDDCConfig, ddc_carrier_init,
                             ddc_carrier_step, direct_ddc_fir)
from gpu_sdr.ops.fold_chain import TonesDirectFoldChain
from gpu_sdr.ops.lockin import lockin_decimate, lockin_profile
from gpu_sdr.ops.pfb import PFBConfig, pfb_frames, pfb_spare_init
from gpu_sdr.params import AntennaParams, AntMode, WaveType

RNG = np.random.default_rng(23)


def crandn(n):
    return (RNG.standard_normal(n) +
            1j * RNG.standard_normal(n)).astype(np.complex64)


# ----------------------------------------------------------------------
# TONES->DIRECT fold chain
# ----------------------------------------------------------------------

def _fold(rate, tx_freqs, ampls, rx_freqs, M, f, L):
    cfg = DirectDDCConfig(rate=rate, decim=M, pf_average=f,
                          freqs=tuple(rx_freqs), phases=(0,) * len(rx_freqs))
    return TonesDirectFoldChain(rate=rate, tx_freqs=tuple(tx_freqs),
                                tx_ampls=tuple(ampls), cfg=cfg,
                                block_len=L), cfg


def _fold_golden(rate, tx_freqs, ampls, rx_freqs, M, f, n):
    x = golden.tone_block(list(tx_freqs), list(ampls), rate, 0, n)
    return golden.GoldenDirectDemodulator(list(rx_freqs), rate, M, f)(x).T


def _fold_run(chain, n_blocks, K=1):
    st = chain.init_state()
    outs = []
    for _ in range(n_blocks // K):
        st, y = chain.multi_step(st, K)
        outs.append(cplx.to_np(y))
    return np.concatenate(outs, axis=0), st


@pytest.mark.parametrize("n_tx,n_rx,M,f,L", [
    (5, 3, 10, 4, 480),
    (2, 2, 16, 2, 512),
    (4, 1, 8, 8, 1024),
])
def test_fold_chain_matches_golden(n_tx, n_rx, M, f, L):
    rate = 10_000
    tx = [int(x) for x in np.linspace(-3000, 3000, n_tx)]
    ampls = [0.3 + 0.1 * i for i in range(n_tx)]
    chain, _ = _fold(rate, tx, ampls, tx[:n_rx], M, f, L)
    assert chain.ok
    out, _ = _fold_run(chain, 4)
    ref = _fold_golden(rate, tx, ampls, tx[:n_rx], M, f, 4 * L)
    assert out.shape == ref.shape
    assert golden.snr_db(ref, out) > 90.0


def test_fold_chain_first_block_zero_history():
    """Block 0's FIR history is zero, not synthesized from a block -1."""
    rate, M, f, L = 10_000, 10, 4, 480
    chain, _ = _fold(rate, (1000, -2000), (0.5, 0.25), (1000, -2000),
                     M, f, L)
    out, _ = _fold_run(chain, 1)
    ref = _fold_golden(rate, (1000, -2000), (0.5, 0.25), (1000, -2000),
                       M, f, L)
    assert golden.snr_db(ref[:f - 1], out[:f - 1]) > 90.0
    assert golden.snr_db(ref, out) > 90.0


def test_fold_chain_three_block_stream_golden():
    rate, M, f, L = 10_000, 10, 4, 800
    tx = (1000, -2500, 400)
    chain, _ = _fold(rate, tx, (0.5, 0.3, 0.2), tx, M, f, L)
    out, _ = _fold_run(chain, 3)
    ref = _fold_golden(rate, tx, (0.5, 0.3, 0.2), tx, M, f, 3 * L)
    assert golden.snr_db(ref, out) > 95.0


def test_fold_chain_rejects_non_decimating_rx():
    chain, _ = _fold(10_000, (100,), (1.0,), (100,), 0, 4, 480)
    assert not chain.ok


def test_fold_chain_multi_step_equals_sequential():
    """multi_step(state, K) == K sequential step() calls, state included."""
    chain, _ = _fold(10_000, (1234, -2777, 401), (0.5, 0.3, 0.2),
                     (1234, -2777), 10, 4, 480)
    seq, st1 = _fold_run(chain, 3, K=1)
    multi, st3 = _fold_run(chain, 3, K=3)
    np.testing.assert_allclose(multi, seq, rtol=0, atol=1e-6)
    for a, b in zip(st1[:2], st3[:2]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_fold_chain_24_channel_comb_golden():
    rate = 1_000_000
    freqs = [int(x) for x in np.linspace(-450_000, 450_000, 24)]
    chain, _ = _fold(rate, freqs, [0.05] * 24, freqs, 20, 4, 8_000)
    out, _ = _fold_run(chain, 4, K=4)
    ref = _fold_golden(rate, freqs, [0.05] * 24, freqs, 20, 4, 32_000)
    assert golden.snr_db(ref, out) > 90.0


@pytest.mark.parametrize("rx_freqs", [
    (12_345, -67_891, 300_001),     # RX tones == TX comb
    (12_345, -67_891, 299_999),     # one RX tone off the comb
])
def test_fold_chain_rx_on_and_off_comb(rx_freqs):
    rate, tx = 1_000_000, (12_345, -67_891, 300_001)
    chain, _ = _fold(rate, tx, (0.3, 0.3, 0.4), rx_freqs, 100, 4, 100_000)
    out, _ = _fold_run(chain, 2, K=2)
    ref = _fold_golden(rate, tx, (0.3, 0.3, 0.4), rx_freqs, 100, 4,
                       200_000)
    assert golden.snr_db(ref, out) > 90.0


def test_fold_chain_ten_tones_offset_rx_golden():
    rate = 1_000_000
    tx = [int(x) for x in np.linspace(-400_000, 400_000, 10)]
    rx = [f + 1000 for f in tx]
    chain, _ = _fold(rate, tx, [0.1] * 10, rx, 10, 4, 25_600)
    out, _ = _fold_run(chain, 2)
    ref = _fold_golden(rate, tx, [0.1] * 10, rx, 10, 4, 51_200)
    assert golden.snr_db(ref, out) > 90.0


# ----------------------------------------------------------------------
# DDC + decimating FIR
# ----------------------------------------------------------------------

def _ddc_stream(rate, M, f, freqs, blocks):
    cfg = DirectDDCConfig(rate=rate, decim=M, pf_average=f,
                          freqs=tuple(freqs), phases=(0,) * len(freqs))
    L = len(blocks[0])
    hmod, ramp = cfg.modulated_taps(), cfg.carrier_ramp(L // M)
    stepv = ddc_carrier_step(cfg, L)
    step = jax.jit(lambda p, h, x: direct_ddc_fir(hmod, ramp, stepv, rate,
                                                  M, f, p, h, x))
    p, h = ddc_carrier_init(cfg, L), cplx.zeros((f - 1) * M)
    outs = []
    for b in blocks:
        p, h, y = step(p, h, cplx.from_np(b))
        outs.append(cplx.to_np(y))
    return np.concatenate(outs, axis=0)


@pytest.mark.parametrize("n_tones,M,f,L", [
    (7, 10, 4, 480),      # many channels, small block
    (1, 10, 4, 480),      # single channel
    (5, 16, 2, 512),      # short FIR
    (3, 8, 8, 1024),      # long overlap (f-1 = 7 history rows)
    (2, 7, 4, 91),        # 13 output rows per block
])
def test_ddc_fir_matches_golden_stream(n_tones, M, f, L):
    rate = 10_000
    freqs = [int(x) for x in np.linspace(-rate // 3, rate // 3, n_tones)]
    blocks = [crandn(L) for _ in range(3)]
    out = _ddc_stream(rate, M, f, freqs, blocks)
    gold = golden.GoldenDirectDemodulator(freqs, rate, M, f)
    ref = gold(np.concatenate(blocks)).T
    assert out.shape == ref.shape
    assert golden.snr_db(ref, out) > 90.0


def test_ddc_fir_three_tone_block_continuity():
    rate, M, f, L = 10_000, 10, 4, 800
    freqs = (1000, -2500, 333)
    blocks = [crandn(L) for _ in range(3)]
    out = _ddc_stream(rate, M, f, freqs, blocks)
    gold = golden.GoldenDirectDemodulator(freqs, rate, M, f)
    ref = np.concatenate([gold(b) for b in blocks], axis=1).T
    assert golden.snr_db(ref, out) > 90.0


# ----------------------------------------------------------------------
# PFB pre-sum + DFT
# ----------------------------------------------------------------------

def _pfb_stream(nfft, avg, blocks):
    cfg = PFBConfig(nfft=nfft, avg=avg, rate=nfft * 1000)
    window, dft = cfg.window(), cfg.dft()
    fn = jax.jit(lambda s, x: pfb_frames(cfg, window, dft, s, x))
    spare = pfb_spare_init(cfg)
    outs = []
    for b in blocks:
        spare, fr = fn(spare, cplx.from_np(b))
        outs.append(cplx.to_np(fr))
    return np.concatenate(outs, axis=0)


@pytest.mark.parametrize("nfft,avg,n_blocks,frames_per_block", [
    (64, 4, 3, 24), (100, 2, 2, 24), (128, 8, 2, 24), (64, 4, 3, 32)])
def test_pfb_matches_golden_stream(nfft, avg, n_blocks, frames_per_block):
    blocks = [crandn(nfft * frames_per_block) for _ in range(n_blocks)]
    out = _pfb_stream(nfft, avg, blocks)
    ref = golden.pfb_frames(np.concatenate(blocks), nfft, avg)
    skip = avg - 1                       # zero-primed startup frames
    n = min(len(ref), len(out) - skip)
    assert golden.snr_db(ref[:n], out[skip:skip + n]) > 90.0


# ----------------------------------------------------------------------
# Chirp mix-down + lock-in
# ----------------------------------------------------------------------

def _lockin_stream(cfg, ppt, blocks):
    prof = jnp.asarray(lockin_profile(ppt))

    @jax.jit
    def step(last, x):
        last, z = chirp_demod_block(cfg, last, x)
        return last, lockin_decimate(prof, z)

    last, outs = jnp.uint32(0), []
    for b in blocks:
        last, y = step(last, cplx.from_np(b))
        outs.append(cplx.to_np(y))
    return np.concatenate(outs)


@pytest.mark.parametrize("f0,f1,steps,chirp_t,nseg,n_blocks", [
    (-300_000, 300_000, 100, 0.02, 64, 1),     # one block
    (0, 200_000, 50, 0.01, 32, 2),             # block continuity
    (-300_000, 300_000, 128, 0.0256, 32, 4),   # blocks tile one period
])
def test_chirp_lockin_matches_golden(f0, f1, steps, chirp_t, nseg,
                                     n_blocks):
    rate = 1_000_000
    cfg = ChirpConfig.from_params(f0, f1, rate, steps, chirp_t)
    ppt = cfg.length
    x = crandn(n_blocks * nseg * ppt)
    out = _lockin_stream(cfg, ppt, np.split(x, n_blocks))
    cp = golden.ChirpParameter(f0, f1, rate, steps, chirp_t)
    ref = golden.GoldenVNADecimator(ppt)(golden.chirp_demod(cp, 0, x))
    assert out.shape == ref.shape
    assert golden.snr_db(ref, out) > 90.0


def test_chirp_demodulator_across_period_wrap():
    """The host-fed CHIRP demodulator over 5 blocks that wrap the chirp
    period twice matches the oracle."""
    rx = AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=64_000,
                       samples=320_000, freq=[-300_000], chirp_f=[300_000],
                       chirp_t=[0.128], swipe_s=[128], decim=1,
                       wave_type=[WaveType.CHIRP])
    from gpu_sdr.engine.demodulator import make_demodulator
    d = make_demodulator(rx)
    assert d.plan.block_len == 64_000
    x = crandn(5 * 64_000)
    out = d.run(np.split(x, 5))
    ref = golden.expected_stream(rx, x)
    assert out.shape == ref.shape
    assert golden.snr_db(ref, out) > 90.0


# ----------------------------------------------------------------------
# Resident replay scan
# ----------------------------------------------------------------------

def _replay(rx, rec, K=2):
    dr = DeviceReplay(rx, rec, blocks_per_exec=K, loop=True)
    assert dr.path == "scan"
    sink = MemorySink()
    dr.run([sink])
    return sink.data


def test_replay_direct_loop_seam_golden():
    """9 blocks from a 3-block recording: wraps twice, K=3 per exec."""
    rx = AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=50_000,
                       samples=450_000, decim=10, pf_average=4,
                       freq=[100_000, -250_000],
                       wave_type=[WaveType.DIRECT] * 2)
    rec = crandn(150_000)
    out = _replay(rx, rec, K=3)
    ref = golden.expected_stream(rx, np.resize(rec, 450_000))
    assert golden.snr_db(ref, out) > 90.0


@pytest.mark.parametrize("freqs,ampls", [
    ((100_000, -250_000, 40_000), (0.3, 0.3, 0.3)),
    ((100_000,), (0.5,)),
])
def test_replay_comb_recording_amplitudes(freqs, ampls):
    """A looped comb recording demodulates to its tone amplitudes."""
    rate, M, f = 1_000_000, 100, 4
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=80_000,
                       samples=240_000, decim=M, pf_average=f,
                       freq=list(freqs),
                       wave_type=[WaveType.DIRECT] * len(freqs))
    rec = golden.tone_block(list(freqs), list(ampls), rate, 0,
                            80_000).astype(np.complex64)
    out = _replay(rx, rec)
    assert np.abs(np.abs(out[f:]) - np.asarray(ampls)).max() < 2e-3


def test_replay_rejects_non_commensurate_loop():
    rx = AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=50_000,
                       samples=100_000, decim=10, pf_average=4,
                       freq=[1000], wave_type=[WaveType.DIRECT])
    with pytest.raises(AssertionError, match="len % block"):
        DeviceReplay(rx, crandn(75_000), loop=True)


@pytest.mark.parametrize("wave,extra", [
    (WaveType.TONES, dict(fft_tones=64, freq=[5 * 16_000, -10 * 16_000])),
    (WaveType.NOISE, dict(fft_tones=64, freq=[0])),
    (WaveType.CHIRP, dict(decim=5, freq=[-300_000], chirp_f=[300_000],
                          chirp_t=[0.1], swipe_s=[100])),
])
def test_replay_modes_match_golden(wave, extra):
    n_ch = len(extra["freq"]) if wave == WaveType.TONES else 1
    rate = 1_024_000 if wave != WaveType.CHIRP else 1_000_000
    L = 64_000 if wave != WaveType.CHIRP else 80_000
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=L,
                       samples=6 * L, pf_average=4,
                       wave_type=[wave] * n_ch, **extra)
    rec = crandn(2 * L)
    out = _replay(rx, rec)
    ref = golden.expected_stream(rx, np.resize(rec, 6 * L))
    n = min(len(ref), len(out))
    assert golden.snr_db(ref[:n], out[:n]) > 90.0


# ----------------------------------------------------------------------
# The parity checks chip_smoke.py runs at production widths, here small
# ----------------------------------------------------------------------

def _small_rx(wave, **kw):
    return AntennaParams(mode=AntMode.RX, rate=1_000_000,
                         buffer_len=100_000, samples=400_000, **kw,
                         wave_type=[wave] * len(kw.get("freq", [0])))


@pytest.mark.parametrize("check", [
    lambda: parity.check_demod("ddc_fir", _small_rx(
        WaveType.DIRECT, decim=10, pf_average=4,
        freq=[100_000, -250_000]), 20_000, reps=1),
    lambda: parity.check_demod("pfb", _small_rx(
        WaveType.TONES, fft_tones=1000, pf_average=4,
        freq=[50_000, -200_000]), 20_000, reps=1),
    lambda: parity.check_demod("chirp", _small_rx(
        WaveType.CHIRP, decim=1, freq=[-300_000], chirp_f=[300_000],
        chirp_t=[0.1], swipe_s=[100]), 20_000, reps=1),
    lambda: parity.check_fold_chain(
        AntennaParams(mode=AntMode.TX, rate=1_000_000, buffer_len=100_000,
                      freq=[100_000, -250_000], ampl=[0.3, 0.3],
                      wave_type=[WaveType.TONES] * 2),
        _small_rx(WaveType.DIRECT, decim=10, pf_average=4,
                  freq=[100_000, -250_000]), 20_000, 2, reps=1),
    lambda: parity.check_replay(_small_rx(
        WaveType.DIRECT, decim=10, pf_average=4,
        freq=[100_000, -250_000]), 2, 20_000, blocks_per_exec=2, reps=1),
], ids=["ddc_fir", "pfb", "chirp", "fold_chain", "replay"])
def test_parity_checks_small_widths(check):
    r = check()
    assert r.snr_db > 90.0, r
    assert r.compile_s > 0 and r.run_s > 0 and r.msps > 0


# the only jax.experimental modules the package may import: the sharded
# paths' multi-host gather and nothing that hand-writes kernels
ALLOWED_EXPERIMENTAL = {"jax.experimental.multihost_utils"}


def test_package_imports_no_kernel_language():
    """Every path of the package is plain jax.numpy / lax left to XLA:
    no module reaches into jax.experimental beyond the allowed helpers."""
    pkg = pathlib.Path(__file__).resolve().parents[1] / "gpu_sdr"
    offenders = []
    for py in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(py.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = ([f"{node.module}.{a.name}" for a in node.names]
                         if node.module == "jax.experimental"
                         else [node.module])
            else:
                continue
            offenders += [f"{py.name}:{node.lineno} {n}" for n in names
                          if n.startswith("jax.experimental")
                          and n not in ALLOWED_EXPERIMENTAL]
    assert not offenders, offenders
