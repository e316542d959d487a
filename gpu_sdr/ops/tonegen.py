"""Multi-tone TX comb synthesis.

The reference builds a rate-length wavetable once via an unnormalized
inverse cuFFT and serves blocks by pointer rotation (tone_gen,
cpp/kernels.cu:589-684; get_from_tones, cpp/USRP_buffer_generator.cpp:226).
A rate-length wavetable (800 MB at 100 Msps) is hostile to HBM, so here each
block is synthesized directly as a matmul using the exact factorization of the
integer-phase oscillator over a tile decomposition n = u*S + v:

    x[base + u*S + v] = sum_c A_c * osc_c[base] * osc_c[u*S] * osc_c[v]
                      = (P * rot)[u, :] @ Q[:, v]

with P[u, c] = exp(2j*pi*(f_c*u*S mod W)/W) (U x C, precomputed),
Q[c, v] = A_c * exp(2j*pi*(f_c*v mod W)/W) (C x S, precomputed), and
rot_c = exp(2j*pi*phase_c/W) from an int32 per-channel phase accumulator
carried across blocks — one (U, C) x (C, S) complex matmul per block,
identical samples to the reference wavetable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import C


def _tile_split(L: int) -> Tuple[int, int]:
    """Pick the divisor pair (U, S) of L with S closest to sqrt(L)."""
    s = 1
    for d in range(1, int(np.sqrt(L)) + 1):
        if L % d == 0:
            s = d
    return L // s, s


@dataclasses.dataclass(frozen=True)
class ToneCombConfig:
    rate: int
    freqs: Tuple[int, ...]
    ampls: Tuple[float, ...]
    block_len: int
    scale: float = 1.0

    def factors(self):
        """Precompute (P, Q): P (U, C), Q (C, S) from exact integer phases."""
        W = self.rate
        U, S = _tile_split(self.block_len)
        fr = np.asarray(self.freqs, dtype=np.int64) % W
        u = np.arange(U, dtype=np.int64)
        v = np.arange(S, dtype=np.int64)
        ph_p = (fr[None, :] * ((u[:, None] * S) % W)) % W
        ph_q = (fr[:, None] * (v[None, :] % W)) % W
        P = np.exp(2j * np.pi * (ph_p / float(W)))
        Q = (np.asarray(self.ampls, dtype=np.float64)[:, None] *
             np.exp(2j * np.pi * (ph_q / float(W)))) * self.scale
        return (cplx.const(P.astype(np.complex64)),
                cplx.const(Q.astype(np.complex64)))

    def phase_init(self) -> jax.Array:
        return jnp.zeros(len(self.freqs), dtype=jnp.int32)

    def phase_step(self) -> jax.Array:
        W = self.rate
        fr = np.asarray(self.freqs, dtype=np.int64)
        return jnp.asarray(((fr * self.block_len) % W).astype(np.int32))


def comb_period(freqs, rate: int) -> int:
    """Fundamental period of the tone comb in samples:
    rate / gcd(rate, f_1, ..., f_C).  Bin-aligned combs (the reference's
    PFB mode quantizes tones to bin centers, pyUSRP/USRP_low_level.py:261)
    have tiny periods (<= nfft), making wavetable synthesis free."""
    import math
    g = int(rate)
    for f in freqs:
        g = math.gcd(g, abs(int(f)))
        if g == 1:
            break
    return int(rate) // max(g, 1)


def tone_comb_wavetable_block(freqs, ampls, rate: int, block_len: int,
                              scale: float = 1.0) -> C:
    """Precompute one block of a *periodic* comb by tiling its fundamental
    period (requires block_len % comb_period == 0).  The device form of
    the reference's wavetable pointer rotation (get_from_tones,
    cpp/USRP_buffer_generator.cpp:226-229): per-block cost is zero — the
    block is a constant; phase carry is trivial (advance mod period = 0).
    """
    import numpy as np
    period = comb_period(freqs, rate)
    assert block_len % period == 0
    n = np.arange(period, dtype=np.int64)
    x = np.zeros(period, dtype=np.complex128)
    W = int(rate)
    for f, a in zip(freqs, ampls):
        ph = ((int(f) % W) * (n % W)) % W
        x += a * np.exp(2j * np.pi * ph / W)
    tile = (x * scale).astype(np.complex64)
    full = np.tile(tile, block_len // period)
    from . import cplx as _cplx
    return _cplx.const(full)


def tone_comb_block(P: C, Q: C, step: jax.Array, W: int,
                    phase: jax.Array):
    """Generate one block: returns (new_phase, x) with x of shape (U*S,)."""
    theta = phase.astype(jnp.float32) * jnp.float32(2.0 * np.pi / W)
    rot = cplx.expi(theta)
    x = cplx.matmul(cplx.mul(P, C(rot.re[None, :], rot.im[None, :])), Q)
    new_phase = phase + step
    new_phase = jnp.where(new_phase >= W, new_phase - W, new_phase)
    return new_phase, x.reshape(-1)


def tone_comb_wavetable(freqs, ampls, rate: int,
                        scale: float = 1.0) -> np.ndarray:
    """Reference-style full-period wavetable via iFFT (host-side; for tests
    and small rates only).  x[n] = scale * sum_c A_c exp(2j*pi*f_c*n/rate)
    (reference tone_gen, cpp/kernels.cu:589-684)."""
    spec = np.zeros(rate, dtype=np.complex128)
    for f, a in zip(freqs, ampls):
        spec[int(f) % rate] += a
    return (np.fft.ifft(spec) * rate * scale).astype(np.complex64)
