"""Chirp generation and lock-in demodulation (CHIRP / VNA mode).

Bit-exact reimplementation of the reference's integer phase accumulator
(chirp_gen / chirp_demodulator, cpp/kernels.cu:335-441).  All phase math is
wrapping uint32 arithmetic — identical mod 2^32 to the reference's uint64
intermediate computation — so the demodulated stream and the VNA frequency
axis reconstruction (pyUSRP/USRP_VNA.py:740-742) match exactly.

The only approximation is the final sin/cos: the reference evaluates
sinpi/cospi in float64 of phase = index/2^31.5; here it is evaluated in
float32, bounding the phase error by ~2^-23 turns (~ -127 dBc) — far below
the measurement SNR bound.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import golden
from . import cplx
from .cplx import C

_TWO_31_5 = np.float32(1.0 / golden.TWO_31_5)


@dataclasses.dataclass(frozen=True)
class ChirpConfig:
    """Quantized chirp descriptor (reference chirp_parameter,
    headers/kernels.cuh:58-64, built in cpp/USRP_demodulator.cpp:192-221)."""

    num_steps: int      # frequency steps in the sweep
    length: int         # samples per step
    chirpness: int      # uint32 quadratic-phase coefficient
    f0: int             # int32 start-frequency phase increment

    @classmethod
    def from_params(cls, f_start: int, f_end: int, rate: int,
                    num_steps: int, chirp_t: float) -> "ChirpConfig":
        cp = golden.ChirpParameter(f_start, f_end, rate, num_steps, chirp_t)
        return cls(num_steps=cp.num_steps, length=cp.length,
                   chirpness=int(cp.chirpness), f0=int(cp.f0))

    @property
    def period(self) -> int:
        p = self.num_steps * self.length
        assert p < 2 ** 31, "chirp period must fit in int31 for uint32 math"
        return p


def chirp_phase_index(cfg: ChirpConfig, last_index: jax.Array,
                      n: jax.Array) -> jax.Array:
    """int32 phase-accumulator values for sample offsets n (uint32 vector).

    Exact wrapping-uint32 mirror of the reference kernel arithmetic
    (cpp/kernels.cu:344-366): all products/sums are congruent mod 2^32 to the
    reference's uint64 computation, and the final truncation to int is the
    same bit pattern.
    """
    period = jnp.uint32(cfg.period)
    length = jnp.uint32(cfg.length)
    chirpness = jnp.uint32(cfg.chirpness & 0xFFFFFFFF)
    f0 = jnp.uint32(cfg.f0 & 0xFFFFFFFF)
    one = jnp.uint32(1)
    two = jnp.uint32(2)

    # eff = (last_index + n) mod period, without uint32 overflow:
    # both terms are reduced below period < 2^31 first.
    eff = (last_index % period) + (n % period)
    eff = jnp.where(eff >= period, eff - period, eff)

    fi = eff // length
    q_phase = (fi // two) * (fi + one) + (fi % two) * ((fi + one) // two)
    pc = chirpness * (length * q_phase)
    idx = eff * (f0 + fi * chirpness) - pc
    return idx.astype(jnp.int32)


def _chirp_wave(cfg: ChirpConfig, last_index: jax.Array,
                block_len: int) -> C:
    """The unit chirp waveform sin(th) - 1j*cos(th) as a (re, im) pair."""
    n = jnp.arange(block_len, dtype=jnp.uint32)
    idx = chirp_phase_index(cfg, last_index, n)
    t = idx.astype(jnp.float32) * _TWO_31_5
    th = jnp.float32(np.pi) * t
    return C(jnp.sin(th), -jnp.cos(th))


def _advance(cfg: ChirpConfig, last_index: jax.Array,
             block_len: int) -> jax.Array:
    return (last_index + jnp.uint32(block_len % cfg.period)) % \
        jnp.uint32(cfg.period)


def chirp_block(cfg: ChirpConfig, last_index: jax.Array, block_len: int,
                scale: float = 1.0):
    """Generate one TX chirp block of `block_len` samples.

    Returns (new_last_index, x) with
    x[n] = scale * (sin(th) - 1j*cos(th)), th = pi*idx/2^31.5
    (reference chirp_gen, cpp/kernels.cu:367-368).
    """
    x = cplx.scale(_chirp_wave(cfg, last_index, block_len),
                   jnp.float32(scale))
    return _advance(cfg, last_index, block_len), x


def chirp_demod_block(cfg: ChirpConfig, last_index: jax.Array, x: C):
    """Demodulate one RX block: out = conj(chirp) * x
    (reference chirp_demodulator, cpp/kernels.cu:389-427).

    Returns (new_last_index, z)."""
    block_len = x.shape[0]
    c = _chirp_wave(cfg, last_index, block_len)
    z = cplx.conj_mul(c, x)
    return _advance(cfg, last_index, block_len), z
