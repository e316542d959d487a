"""Closed-form TONES->DIRECT loopback chain: the shift-fold formulation.

Per output row r, the loopback's synthesis -> mix-down -> decimating FIR
is f = pf_average dots against the fused synthesis-x-taps constant G:

    y[r, c] = sum_j sum_t (srot_t * P[r+j, t]) * G[j, t, c]

But P is the comb's integer-phase Vandermonde,
P[n, t] = exp(2j*pi*f_t*n*M/W), so the shifted rows factor EXACTLY:

    P[r+j, t] = P[r, t] * exp(2j*pi*f_t*j*M/W)

and the whole j loop folds into the constant host-side (float64):

    G2[t, c] = sum_j exp(2j*pi*((f_t*j*M) mod W)/W) * G[j, t, c]
    y[r, c]  = (sum_t (srot_t * P[r, t]) * G2[t, c]) * ramp[r, c] * drot_c

ONE complex (nb, C_t) x (C_t, C') matmul per block and no halo
machinery, while staying EXACT single-stage DIRECT arithmetic (>300 dB
vs the float64 oracle; tests/test_fold_chain.py).  The only special case
is the stream's first pf_average-1 output rows: their zero-history
startup transient (GoldenFIR semantics) is restored by subtracting a
tiny (f-1, C_t, C') partial-fold correction on the first block.

The matmul runs at the global matmul precision
(config.configure_precision).  The (nb, C_t) P factor and the (nb, C')
carrier ramp ride the chain state as ARGUMENTS rather than closure
constants, so they are not baked into the compiled program.

Replaces the reference chain tone_gen (cpp/kernels.cu:589-684) +
direct_demodulator_integer (:45-86) + per-channel FIR
(cpp/fir.cu:83-88) for the --sw_loop TONES->DIRECT path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import C
from .ddc import DirectDDCConfig, ddc_carrier_init, ddc_carrier_step


def _expi_int(ph: np.ndarray, W: int, sign: float = 1.0) -> np.ndarray:
    """exp(sign * 2j*pi*ph/W) for exact integer phases, float64."""
    return np.exp(sign * 2j * np.pi * (np.asarray(ph, np.float64) / W))


@dataclasses.dataclass
class TonesDirectFoldChain:
    """Compiled shift-fold TONES->DIRECT loopback for one geometry.

    Build once per measurement; ``multi_step(state, K)`` emits
    (K*nb, C') demodulated rows with no input — synthesis, mix-down and
    FIR are all contracted into the G2 constant.  Persistent state:
    (synth phases (C_t,), DDC phases (C',), startup flag, P, ramp).
    """

    path_name = "fold_chain"

    rate: int
    tx_freqs: Tuple[int, ...]
    tx_ampls: Tuple[float, ...]
    cfg: DirectDDCConfig
    block_len: int
    scale: float = 1.0

    def __post_init__(self):
        W, L, M, f = self.rate, self.block_len, self.cfg.M, self.cfg.f
        self.ok = (self.cfg.decim > 0 and L % M == 0
                   and len(self.tx_freqs) > 0)
        if not self.ok:
            return
        nb = L // M
        self.nb = nb
        Ct, Cp = len(self.tx_freqs), self.cfg.n_channels
        self.Ct, self.Cp = Ct, Cp
        fr = np.asarray(self.tx_freqs, dtype=np.int64) % W
        n = np.arange(nb, dtype=np.int64)
        m = np.arange(M, dtype=np.int64)
        j = np.arange(f, dtype=np.int64)
        # P, Q from exact integer phases (float64)
        P = _expi_int((fr[None, :] * ((n[:, None] * M) % W)) % W, W)
        Q = (np.asarray(self.tx_ampls, dtype=np.float64)[:, None] *
             _expi_int((fr[:, None] * m[None, :]) % W, W)) * self.scale
        hmod = self.cfg.modulated_taps_np()          # (f*M, Cp) float64
        G = np.einsum("tm,jmc->jtc", Q, hmod.reshape(f, M, Cp))
        shift = _expi_int((fr[:, None] * ((j[None, :] * M) % W)) % W, W)
        G2 = np.einsum("tj,jtc->tc", shift, G)
        # startup partial folds: output row r of the stream's first block
        # misses taps j < f-1-r (zero history, GoldenFIR semantics)
        G2p = np.stack([
            np.einsum("tj,jtc->tc", shift[:, :f - 1 - r], G[:f - 1 - r])
            for r in range(f - 1)]) if f > 1 else np.zeros((0, Ct, Cp))
        self._P = cplx.const(P.astype(np.complex64))
        self._ramp = self.cfg.carrier_ramp(nb)
        self._G2 = cplx.const(G2.astype(np.complex64))
        self._G2p = cplx.const(G2p.astype(np.complex64))
        self._sstep = jnp.asarray(((fr * L) % W).astype(np.int32))
        self._dstep = ddc_carrier_step(self.cfg, L)
        abs0 = -((f - 1) * M)
        self._sph0 = jnp.asarray(((fr * abs0) % W).astype(np.int32))

    def init_state(self):
        # device copies: the 32 MB-class P/ramp factors ride the state so
        # they cross the jit boundary as arguments; the small phase
        # vectors are copied too so the masters survive a donating caller
        return (jnp.copy(self._sph0),
                ddc_carrier_init(self.cfg, self.block_len),
                jnp.float32(0.0),
                C(jnp.copy(self._P.re), jnp.copy(self._P.im)),
                C(jnp.copy(self._ramp.re), jnp.copy(self._ramp.im)))

    def scan_blocks(self, sph, dph, pv, P, ramp, G2, G2p, K: int,
                    sstep, dstep, startup=True):
        """K blocks of the chain from explicit operands: synthesis phases
        sph (C_t,), DDC phases dph (C',), startup flag pv (0 = stream
        start), the P (rows, C_t) and ramp (rows, C') factors, G2
        (C_t, C') and the startup partial folds G2p.  Returns
        ((sph, dph, pv), ys (K, rows, C')).  `startup` says whether these
        rows include the stream's first f-1 (the sharded chain passes
        False on every time shard but the first)."""
        W, f = self.rate, self.cfg.f
        two_pi_w = jnp.float32(2.0 * np.pi / W)

        def body(carry, _):
            sph, dph, pv = carry
            srot = cplx.expi(sph.astype(jnp.float32) * two_pi_w)
            drot = cplx.expi_neg(dph.astype(jnp.float32) * two_pi_w)
            Pb = cplx.mul(P, C(srot.re[None, :], srot.im[None, :]))
            acc = cplx.matmul(Pb, G2)
            if f > 1:
                # restore the zero-history startup transient on the
                # stream's first block (pv = 0) by removing the missing
                # taps' contribution from the first f-1 rows
                h = Pb[:f - 1]
                cr = (jnp.einsum("rt,rtc->rc", h.re, G2p.re) -
                      jnp.einsum("rt,rtc->rc", h.im, G2p.im))
                ci = (jnp.einsum("rt,rtc->rc", h.re, G2p.im) +
                      jnp.einsum("rt,rtc->rc", h.im, G2p.re))
                g = jnp.where(startup, jnp.float32(1.0) - pv,
                              jnp.float32(0.0))
                acc = C(acc.re.at[:f - 1].add(-g * cr),
                        acc.im.at[:f - 1].add(-g * ci))
            y = cplx.mul(cplx.mul(acc, ramp),
                         C(drot.re[None, :], drot.im[None, :]))
            nsph = sph + sstep
            nsph = jnp.where(nsph >= W, nsph - W, nsph)
            ndph = dph + dstep
            ndph = jnp.where(ndph >= W, ndph - W, ndph)
            return (nsph, ndph, jnp.float32(1.0)), y

        return jax.lax.scan(body, (sph, dph, pv), None, length=K)

    def multi_step(self, state, K: int):
        sph, dph, pv, P, ramp = state
        (sph, dph, pv), ys = self.scan_blocks(
            sph, dph, pv, P, ramp, self._G2, self._G2p, K, self._sstep,
            self._dstep)
        y = C(ys.re.reshape(K * self.nb, self.Cp),
              ys.im.reshape(K * self.nb, self.Cp))
        return (sph, dph, pv, P, ramp), y

    def step(self, state):
        state, y = self.multi_step(state, 1)
        return state, y
