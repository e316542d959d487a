"""Fused multi-tone direct down-conversion + decimating FIR.

Re-design of the reference DIRECT-mode hot path
(direct_demodulator_integer, cpp/kernels.cu:45-86, followed by per-channel
FIR::run_fir, cpp/fir.cu:83-88).  The reference materializes the full
(n_tones x buffer_len) mixed-down intermediate (DIRECT_output_size,
cpp/USRP_demodulator.cpp:82) — its dominant memory cost — and then runs one
GEMM per channel.

Here the mix-down and the FIR fold into ONE complex matmul per block, because
the integer-phase oscillator is an exact exponential:

    osc_c[k] = exp(-2j*pi*(p_c + f_c*k)/W)        (W = rate)
    y_c[n]   = sum_i h[i] * xe[nM+i] * osc_c[abs0 + nM + i]
             = carrier_c[n] * sum_i (h[i]*e^{-2j*pi*f_c*i/W}) * xe[nM+i]

so with Hmod[i, c] = h[i]*exp(-2j*pi*f_c*i/W) (precomputed, (f*M, C)) the
inner sum is a strided correlation evaluated as f matmuls of shape
(nb, M) x (M, C), and carrier_c[n] is a separable phase ramp driven by an
exact int32 phase accumulator carried across blocks.

All complex values are float32 (re, im) pairs (see ops/cplx.py); a
complex matmul is 3 real matmuls.  FLOPs: 24*f*C per input sample; no
C x L intermediate.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import C
from .fir import fir_taps_direct


@dataclasses.dataclass(frozen=True)
class DirectDDCConfig:
    """Static precomputed state for the fused DDC+FIR.

    Built host-side once per measurement from the antenna parameters
    (freq list, rate, decim, pf_average).  When ``decim == 0`` the op
    degenerates to the pure mix-down (M=1, f=1, unit tap), matching the
    reference's undecimated DIRECT branch (cpp/USRP_demodulator.cpp:442-456).
    """

    rate: int                 # W: wavetable length == sampling rate
    decim: int                # M: decimation factor (0 -> no filtering)
    pf_average: int           # f: taps per polyphase arm
    freqs: Tuple[int, ...]    # integer tone frequencies [Hz]
    phases: Tuple[int, ...]   # integer initial phases (reference zeroes them)

    @property
    def M(self) -> int:
        return max(int(self.decim), 1)

    @property
    def f(self) -> int:
        return int(self.pf_average) if self.decim > 0 else 1

    @property
    def n_channels(self) -> int:
        return len(self.freqs)

    def modulated_taps_np(self) -> np.ndarray:
        """Hmod[i, c] = h[i] * exp(-2j*pi*f_c*i/W), shape (f*M, C),
        float64 (for host-side constant folding, e.g. the G-fused
        chain's synthesis x taps contraction)."""
        M, f, W = self.M, self.f, self.rate
        if self.decim > 0:
            h = fir_taps_direct(self.decim, self.pf_average, dtype=np.float64)
        else:
            h = np.ones(1, dtype=np.float64)
        i = np.arange(f * M, dtype=np.int64)
        fr = np.asarray(self.freqs, dtype=np.int64)
        ph = (fr[None, :] * (i[:, None] % W)) % W        # exact int phase
        return h[:, None] * np.exp(-2j * np.pi * (ph / float(W)))

    def modulated_taps(self) -> C:
        """`modulated_taps_np` as a device constant (complex64 pair)."""
        return cplx.const(self.modulated_taps_np().astype(np.complex64))

    def carrier_ramp(self, nb: int) -> C:
        """Block-invariant carrier factor:
        R[n, c] = exp(-2j*pi*(f_c*n*M mod W)/W), shape (nb, C)."""
        W, M = self.rate, self.M
        n = np.arange(nb, dtype=np.int64)
        fr = np.asarray(self.freqs, dtype=np.int64)
        ph = (fr[None, :] * ((n[:, None] * M) % W)) % W
        return cplx.const(
            np.exp(-2j * np.pi * (ph / float(W))).astype(np.complex64))


def ddc_carrier_init(cfg: DirectDDCConfig, block_len: int) -> jax.Array:
    """Initial per-channel int32 phase accumulator P_c.

    P_c tracks (p_c + f_c * abs0) mod W where abs0 is the absolute index of
    the first history sample of the current block, abs0(block 0) =
    -(f-1)*M.  This is the per-channel generalization of the reference's
    DIRECT_current_index bookkeeping (cpp/USRP_demodulator.cpp:437-440).
    """
    W = cfg.rate
    abs0 = -((cfg.f - 1) * cfg.M)
    fr = np.asarray(cfg.freqs, dtype=np.int64)
    p = np.asarray(cfg.phases, dtype=np.int64)
    return jnp.asarray(((p + fr * abs0) % W).astype(np.int32))


def ddc_carrier_step(cfg: DirectDDCConfig, block_len: int) -> jax.Array:
    """Int32 per-channel phase increment per block: (f_c * L) mod W."""
    fr = np.asarray(cfg.freqs, dtype=np.int64)
    return jnp.asarray(((fr * block_len) % cfg.rate).astype(np.int32))


def direct_ddc_fir(
    hmod: C,                  # (f*M, C) modulated taps
    ramp: C,                  # (nb, C) carrier ramp
    step: jax.Array,          # (C,) int32 per-block phase increment
    W: int,                   # rate (modulus)
    M: int,                   # decimation
    f: int,                   # taps per arm
    phase: jax.Array,         # (C,) int32 carried phase accumulator
    hist: C,                  # ((f-1)*M,) carried raw input samples
    x: C,                     # (L,) input block
):
    """One block of fused DDC+FIR.  Returns (phase', hist', y) with y of
    shape (nb, C), nb = L // M (sample-major, channel-minor — the layout the
    wire format and HDF5 writer expect).
    """
    L = x.shape[0]
    nb = L // M
    ze = cplx.concat([hist, x]) if hist.shape[0] else x   # ((nb+f-1)*M,)
    X = ze.reshape(nb + f - 1, M)
    acc = cplx.zeros((nb, hmod.shape[1]), dtype=x.dtype)
    for j in range(f):
        acc = acc + cplx.matmul(X[j:j + nb, :], hmod[j * M:(j + 1) * M, :])
    theta = phase.astype(jnp.float32) * jnp.float32(2.0 * np.pi / W)
    rot = cplx.expi_neg(theta)                             # (C,)
    y = cplx.mul(cplx.mul(acc, ramp), C(rot.re[None, :], rot.im[None, :]))
    new_phase = phase + step
    new_phase = jnp.where(new_phase >= W, new_phase - W, new_phase)
    new_hist = ze[L:] if hist.shape[0] else hist
    return new_phase, new_hist, y
