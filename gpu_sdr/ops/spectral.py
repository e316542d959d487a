"""On-device spectral analysis: batched Welch PSD.

The reference computes per-channel Welch PSDs on the host with
joblib-parallel scipy (calculate_noise, pyUSRP/USRP_noise.py:779-784).
Here the same estimate — periodic Hann window, 50% overlap, per-segment
linear detrend, density scaling — runs as batched matmul work (segment framing
+ DFT matmul), so thousands of channels are analyzed in one device call.

`welch_psd` matches scipy.signal.welch(x, fs, nperseg=..., detrend='linear',
scaling='density') for real inputs (see tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import C, DFT


def hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann window (scipy get_window('hann', n, fftbins=True))."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


def _detrend_linear(seg: jax.Array) -> jax.Array:
    """Remove the least-squares line from each row of (..., n)."""
    n = seg.shape[-1]
    t = jnp.arange(n, dtype=seg.dtype)
    t_mean = (n - 1) / 2.0
    tc = t - t_mean
    denom = jnp.sum(tc * tc)
    x_mean = jnp.mean(seg, axis=-1, keepdims=True)
    slope = jnp.sum(seg * tc, axis=-1, keepdims=True) / denom
    return seg - x_mean - slope * tc


def welch_psd(x: jax.Array, fs: float, nperseg: int,
              detrend: str = "linear", onesided: bool = True):
    """Batched Welch PSD of real input.

    Args:
      x: (..., N) real samples.
      fs: sampling rate.
      nperseg: segment length (noverlap = nperseg//2, like scipy default).

    Returns (freqs (nf,), psd (..., nf)) with nf = nperseg//2+1.
    """
    N = x.shape[-1]
    # scipy-style clamp: a segment longer than the data would gather
    # past the end (JAX clamps indices silently, repeating the last
    # sample into the tail of the segment)
    if nperseg > N:
        import warnings
        warnings.warn(f"nperseg={nperseg} > data length {N}; "
                      f"using nperseg={N}")
        nperseg = N
    step = max(1, nperseg // 2)
    nseg = max(1, (N - nperseg) // step + 1)
    idx = (jnp.arange(nseg) * step)[:, None] + jnp.arange(nperseg)[None, :]
    segs = x[..., idx]                          # (..., nseg, nperseg)
    if detrend == "linear":
        segs = _detrend_linear(segs)
    elif detrend == "constant":
        segs = segs - jnp.mean(segs, axis=-1, keepdims=True)
    win = jnp.asarray(hann_periodic(nperseg))
    segs = segs * win
    dft = DFT(nperseg)
    spec = dft(C(segs, jnp.zeros_like(segs)))
    power = spec.abs2()                         # (..., nseg, nperseg)
    w64 = hann_periodic(nperseg).astype(np.float64)
    scale = 1.0 / (fs * float(np.sum(w64 * w64)))
    psd = power.mean(axis=-2) * scale
    if onesided:
        nf = nperseg // 2 + 1
        psd = psd[..., :nf]
        # double everything except DC (and Nyquist when nperseg even)
        mult = np.full(nf, 2.0, dtype=np.float32)
        mult[0] = 1.0
        if nperseg % 2 == 0:
            mult[-1] = 1.0
        psd = psd * jnp.asarray(mult)
        freqs = np.fft.rfftfreq(nperseg, d=1.0 / fs)
    else:
        freqs = np.fft.fftfreq(nperseg, d=1.0 / fs)
    return freqs, psd


def batched_welch(data: np.ndarray, fs: float, nperseg: int):
    """Host convenience: (C, N) real numpy -> (freqs, (C, nf) numpy)."""
    f, p = jax.jit(functools.partial(welch_psd, fs=fs, nperseg=nperseg)
                   )(jnp.asarray(np.asarray(data, np.float32)))
    return f, np.asarray(p)
