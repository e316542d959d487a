"""Streaming polyphase decimating FIR.

Formulation of the reference ``FIR`` class (cpp/fir.cu:15-88).
The reference's cgemm+caxpy partial-sum machinery reduces to a sliding
correlation with output stride M:

    y[n] = sum_{i=0}^{M*f-1} taps[i] * z[(n-f+1)*M + i]

(see GoldenFIR in gpu_sdr/golden.py for the derivation).  Instead of
carrying f-1 *partial sums* between blocks like the reference, we carry the
last (f-1)*M *input* samples (mathematically identical, and a clean scan
carry), and compute each block's outputs as f matmuls over shifted views
of the block — no O(f x block) framed intermediate is materialized.

Complex data is a float32 (re, im) pair (ops/cplx.py); real taps apply to
both components as plain real matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import C
from .windows import sinc_window


def fir_taps_direct(decim: int, pf_average: int,
                    dtype=np.float32) -> np.ndarray:
    """DIRECT-mode decimator taps: sinc window of length decim*pf_average,
    fc = 0.75/(2*decim) (reference cpp/USRP_demodulator.cpp:99)."""
    return sinc_window(decim * pf_average, 0.75 / (2.0 * decim), dtype=dtype)


def fir_init_state(n_channels: int, decim: int, pf_average: int,
                   dtype=jnp.float32) -> C:
    """Zero history: (n_channels, (f-1)*M) carried input samples.

    The reference's first-block history is an uninitialized device buffer
    (cpp/fir.cu:26 memsets the *pointer*, a latent bug); we define it as
    zeros, which only affects the first f-1 startup-transient outputs.
    """
    return cplx.zeros((n_channels, (pf_average - 1) * decim), dtype=dtype)


def streaming_fir(taps: jax.Array, state: C, z: C):
    """Apply the streaming decimating FIR to one block.

    Args:
      taps:  (M*f,) real taps.
      state: (C, (f-1)*M) carried input history (from fir_init_state).
      z:     (C, L) block input, L % M == 0.

    Returns:
      (new_state, y) with y of shape (C, L//M).
    """
    M_f = taps.shape[0]
    hist = state.shape[-1]
    M = M_f - hist if hist else M_f  # hist = (f-1)*M  =>  M = M_f - hist
    f = M_f // M
    n_ch, L = z.shape
    nb = L // M
    ze = cplx.concat([state, z], axis=-1)      # (C, (nb+f-1)*M)
    X = ze.reshape(n_ch, nb + f - 1, M)
    tap_mat = taps.reshape(f, M)
    y = cplx.zeros((n_ch, nb), dtype=z.dtype)
    for j in range(f):
        y = y + cplx.matmul_cr(X[:, j:j + nb, :], tap_mat[j])
    new_state = ze[:, L:] if hist else state
    return new_state, y
