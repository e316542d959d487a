"""TX block generator factory.

Equivalent of the reference ``TX_buffer_generator``
(cpp/USRP_buffer_generator.cpp): TONES builds a multi-tone comb (the
reference precomputes a rate-length wavetable via inverse cuFFT and rotates a
pointer, cpp/kernels.cu:589-684; here each block is one (U,C)x(C,S)
matmul with identical samples — see ops/tonegen.py), CHIRP generates the
integer-phase sweep per block (reference chirp_gen, cpp/kernels.cu:335-372).

NOISE and RAMP TX are not implemented, matching the reference
(cpp/USRP_buffer_generator.cpp:40-58).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from ..params import AntennaParams, WaveType, chirp_steps_and_length
from ..ops import chirp as chirp_ops
from ..ops import cplx
from ..ops import tonegen as tone_ops


@dataclasses.dataclass
class Generator:
    """A compiled streaming TX generator for one antenna."""

    block_len: int
    init_state: Callable[[], Any]
    step: Callable[[Any], Tuple[Any, jax.Array]]
    wave_type: WaveType

    def blocks(self, n_blocks: int):
        """Yield n_blocks numpy complex blocks (testing / offline use)."""
        state = self.init_state()
        for _ in range(n_blocks):
            state, x = self.step(state)
            yield cplx.to_np(x)


def _apply_burst(gen: Generator, p: AntennaParams) -> Generator:
    """Wrap a generator with burst gating: burst_on seconds of signal,
    burst_off of silence, repeating (the reference implements this with
    timed UHD start/stop-of-burst metadata, single_tx_thread,
    cpp/USRP_hardware_manager.cpp:1178-1291; here it is an on-device mask
    driven by a carried absolute-sample counter)."""
    rate = int(p.rate)
    on = int(round(p.burst_on * rate))
    period = on + int(round(p.burst_off * rate))
    assert period < 2 ** 31, "burst period must fit in int32 samples"
    L = gen.block_len
    inner_step = gen.step
    inner_init = gen.init_state

    def init_state():
        return (inner_init(), jnp.int32(0))

    @jax.jit
    def step(state):
        inner, off = state
        inner, x = inner_step(inner)
        # overflow-safe position-in-period: off + arange(L) could exceed
        # int32 when period is within L of 2**31, so wrap via a shifted
        # difference (off - period is in (-period, 0]; adding a value
        # < period keeps everything inside int32)
        a = jnp.arange(L, dtype=jnp.int32) % jnp.int32(period)
        t = a + (off - jnp.int32(period))
        t = jnp.where(t < 0, t + jnp.int32(period), t)
        mask = (t < on).astype(x.re.dtype)
        from ..ops.cplx import C
        x = C(x.re * mask, x.im * mask)
        new_off = (off + jnp.int32(L % period)) % jnp.int32(period)
        return (inner, new_off), x

    return Generator(block_len=L, init_state=init_state, step=step,
                     wave_type=gen.wave_type)


def make_generator(p: AntennaParams, block_len: int | None = None) -> Generator:
    """Build the TX generator for one antenna (the reference ctor dispatch,
    cpp/USRP_buffer_generator.cpp:39-159)."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    L = int(block_len) if block_len else (p.buffer_len or 1_000_000)

    if w == WaveType.TONES:
        freqs = tuple(int(f) for f in p.freq)
        ampls = tuple(float(a) for a in (p.ampl or [1.0] * len(p.freq)))
        period = tone_ops.comb_period(freqs, p.rate)
        if L % period == 0 and period <= (1 << 22):
            # periodic comb (e.g. PFB bin-aligned tones): the block is a
            # constant — the wavetable path, per-block cost ~zero
            xconst = tone_ops.tone_comb_wavetable_block(
                freqs, ampls, int(p.rate), L)

            @jax.jit
            def step(state):
                return state, xconst

            gen = Generator(block_len=L, init_state=lambda: (),
                            step=step, wave_type=w)
            return _apply_burst(gen, p) if p.burst_on > 0 else gen

        cfg = tone_ops.ToneCombConfig(
            rate=int(p.rate), freqs=freqs, ampls=ampls, block_len=L)
        P, Q = cfg.factors()
        step_v = cfg.phase_step()
        W = int(p.rate)

        def init_state():
            return cfg.phase_init()

        @jax.jit
        def step(phase):
            return tone_ops.tone_comb_block(P, Q, step_v, W, phase)

        gen = Generator(block_len=L, init_state=init_state, step=step,
                        wave_type=w)
        return _apply_burst(gen, p) if p.burst_on > 0 else gen

    if w == WaveType.CHIRP:
        steps, _length = chirp_steps_and_length(p)
        cfg = chirp_ops.ChirpConfig.from_params(
            p.freq[0], p.chirp_f[0], int(p.rate), steps, p.chirp_t[0])
        scale = float(p.ampl[0]) if p.ampl else 1.0

        def init_state():
            return jnp.uint32(0)

        @jax.jit
        def step(last):
            return chirp_ops.chirp_block(cfg, last, L, scale=scale)

        gen = Generator(block_len=L, init_state=init_state, step=step,
                        wave_type=w)
        return _apply_burst(gen, p) if p.burst_on > 0 else gen

    raise NotImplementedError(
        f"TX generation for {w} is not implemented "
        "(NOISE/RAMP/DIRECT TX match the reference's unimplemented cases, "
        "cpp/USRP_buffer_generator.cpp:40-58)")
