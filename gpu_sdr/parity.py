"""Plain XLA paths of the readout chain against the float64 oracles.

Each check builds one production path of the chain — the RX demodulator
step for DIRECT (DDC + decimating FIR), TONES/NOISE (PFB pre-sum + DFT +
tone select) and CHIRP (mix-down + lock-in), the closed-form
TONES->DIRECT loopback chain, and the device-resident replay scan — on
seeded input, times it on whatever device JAX holds, and compares a
leading window of its output with `golden.expected_stream`.

chip_smoke.py (phase P3) and the `gpu`-marked tests run the checks at the
reference deployment's widths on the card; the CPU tests run the same
checks at small widths.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import jax
import numpy as np

from . import golden
from .ops import cplx
from .params import AntennaParams


@dataclasses.dataclass
class ParityResult:
    name: str
    shapes: str
    snr_db: float
    compile_s: float      # first call: trace + compile + one run
    run_s: float          # median wall seconds per call, device-synced
    samples: int          # input samples per timed call

    @property
    def msps(self) -> float:
        return self.samples / self.run_s / 1e6


def _timed(fn, reps: int):
    """(result of the first call, its seconds, median seconds of `reps`
    further calls); every call ends in block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times)


def _noise(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _window_snr(rx: AntennaParams, x: np.ndarray, out: np.ndarray) -> float:
    ref = golden.expected_stream(rx, x)
    n = min(len(ref), len(out))
    assert n > 0, "leading window holds no complete output row"
    return golden.snr_db(ref[:n], out[:n])


def check_demod(name: str, rx: AntennaParams, window: int, seed: int = 0,
                reps: int = 5) -> ParityResult:
    """One block of seeded noise through make_demodulator(rx).step; the
    first `window` samples' output rows against the oracle."""
    from .engine.demodulator import make_demodulator
    demod = make_demodulator(rx)
    L = demod.plan.block_len
    x = _noise(L, seed)
    xc = cplx.from_np(x)
    st = demod.init_state()
    (_, y), first, run = _timed(lambda: demod.step(st, xc), reps)
    out = cplx.to_np(y)
    return ParityResult(name, f"block {L} -> {out.shape}",
                        _window_snr(rx, x[:window], out), first, run, L)


def check_fold_chain(tx: AntennaParams, rx: AntennaParams, window: int,
                     blocks_per_exec: int = 1,
                     reps: int = 5) -> ParityResult:
    """One execution (K blocks) of the closed-form TONES->DIRECT loopback
    chain (ops/fold_chain.py) as FusedLoopback compiles it, against the
    oracle fed the same comb (golden.tone_block)."""
    from .engine.fused import FusedLoopback
    fl = FusedLoopback(tx, rx, blocks_per_exec=blocks_per_exec)
    assert fl.path == "fold_chain", fl.path
    K, L = blocks_per_exec, fl.demod.plan.block_len
    (_, _, y), first, run = _timed(
        lambda: fl._multi(*fl._init_states()), reps)
    out = cplx.to_np(y).reshape(-1, y.shape[-1])
    x = golden.tone_block(tx.freq, tx.ampl or [1.0] * len(tx.freq),
                          int(tx.rate), 0, window)
    return ParityResult("fold_chain", f"{K} x block {L} -> {out.shape}",
                        _window_snr(rx, x, out), first, run, K * L)


def check_replay(rx: AntennaParams, n_rec_blocks: int, window: int,
                 blocks_per_exec: int = 8, seed: int = 0,
                 reps: int = 5) -> ParityResult:
    """A looped seeded recording of `n_rec_blocks` blocks resident on the
    device: one execution (K blocks) of DeviceReplay's compiled scan is
    timed; the acquisition through DeviceReplay.run is compared."""
    import jax.numpy as jnp
    from .engine.planner import plan_blocks
    from .engine.replay import DeviceReplay
    from .engine.sinks import MemorySink
    L = plan_blocks(rx).block_len
    rec = _noise(n_rec_blocks * L, seed)
    dr = DeviceReplay(rx, rec, blocks_per_exec=blocks_per_exec, loop=True)
    st = dr.demod.init_state()
    _, first, run = _timed(lambda: dr._multi(st, jnp.int32(0), dr._X), reps)
    sink = MemorySink()
    dr.run([sink])
    K = blocks_per_exec
    return ParityResult(
        "replay_scan",
        f"recording {len(rec)}, {K} x block {L} per execution "
        f"-> {sink.data.shape} per acquisition",
        _window_snr(rx, rec[:window], sink.data), first, run, K * L)


# ----------------------------------------------------------------------
# Production widths: the reference deployment's shapes, one check per
# plain path that stands where a hand-written kernel stood
# ----------------------------------------------------------------------

PRODUCTION_RATE = 100_000_000


def _tones(n: int):
    return [int(f) for f in np.linspace(-0.45 * PRODUCTION_RATE,
                                        0.45 * PRODUCTION_RATE, n)]


def production_checks():
    """(name, thunk) pairs at production widths: DDC + FIR (100 DIRECT
    tones, decim 100, 4 Msample blocks), the 1000-bin channelizer (PFB
    pre-sum + DFT + select at nfft 1000, avg 4), the CHIRP lock-in at the
    get_VNA.py widths, the closed-form TONES->DIRECT loopback chain, and
    the resident replay scan."""
    from .params import AntMode, WaveType
    rate = PRODUCTION_RATE
    direct = _tones(100)
    rx_direct = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=4_000_000,
        samples=16_000_000, decim=100, pf_average=4, freq=direct,
        wave_type=[WaveType.DIRECT] * 100)
    bins = [k * (rate // 1000) for k in range(-500, 500)]
    rx_pfb = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=4_000_000, fft_tones=1000,
        pf_average=4, freq=bins, wave_type=[WaveType.TONES] * 1000)
    rx_chirp = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=1_000_000, decim=1,
        freq=[-45_000_000], chirp_f=[45_000_000], chirp_t=[10.0],
        swipe_s=[50_000], wave_type=[WaveType.CHIRP])
    tx_direct = AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=4_000_000, freq=direct,
        ampl=[0.01] * 100, wave_type=[WaveType.TONES] * 100)
    return [
        ("ddc_fir", lambda: check_demod("ddc_fir", rx_direct, 100_000)),
        ("pfb_channelizer",
         lambda: check_demod("pfb_channelizer", rx_pfb, 100_000)),
        ("chirp_lockin",
         lambda: check_demod("chirp_lockin", rx_chirp, 200_000)),
        ("fold_chain",
         lambda: check_fold_chain(tx_direct, rx_direct, 100_000,
                                  blocks_per_exec=4)),
        ("replay_scan", lambda: check_replay(rx_direct, 4, 100_000)),
    ]
