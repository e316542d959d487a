"""Polyphase filter bank channelizer (TONES / NOISE modes).

Formulation of the reference PFB front half
(polyphase_filter kernel, cpp/kernels.cu:474-516) + batched forward FFT
(cufftExecC2C, cpp/USRP_demodulator.cpp:501) + tone selection
(tone_select, cpp/kernels.cu:531-554) + spectral frame averaging
(average_spectra/decimate_spectra, cpp/kernels.cu:704-749).

Frame t (hop nfft, support avg*nfft) of a contiguous stream x:

    pre[t, b] = sum_{i<avg} x[t*nfft + b + i*nfft] * w[b + i*nfft]
    out[t]    = FFT_nfft(pre[t])

The reference carries `spare_samples` raw samples between 1 Msample blocks
with on-device move_buffer shuffles and variable per-block batch counts
(buffer_helper, cpp/USRP_server_memory_management.cpp:104-156).  Here the
engine picks block lengths commensurate with nfft, so every block yields a
*static* L/nfft frames and the carry is a fixed (avg-1)*nfft-sample window —
same steady-state frame stream, XLA-friendly shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import golden
from . import cplx
from .cplx import C, DFT
from .windows import pfb_window


def tone_bins(freqs, rate: int, nfft: int) -> np.ndarray:
    """Tone-frequency -> FFT-bin mapping, bit-identical to the reference
    (upload_multitone_parameters, cpp/USRP_demodulator.cpp:702-768)."""
    return golden.tone_bins(freqs, rate, nfft)


@dataclasses.dataclass(frozen=True)
class PFBConfig:
    """Static PFB configuration for one antenna."""

    nfft: int                       # FFT length / number of bins
    avg: int                        # pf_average: taps per bin
    rate: int                       # input sample rate
    bins: Optional[Tuple[int, ...]] = None  # selected bins (None = full spec)
    decim: int = 0                  # extra frame averaging factor

    def window(self, dtype=jnp.float32) -> jax.Array:
        return jnp.asarray(pfb_window(self.nfft, self.avg, dtype=np.float32),
                           dtype=dtype)

    def dft(self, two_stage: bool | None = None) -> DFT:
        """The batched DFT replacing cuFFT (see cplx.DFT).

        two_stage=None -> auto (dense below cplx._TWO_STAGE_MIN).  At the
        tensorfloat32 matmul default the two-stage split is ~20% faster at
        nfft=1024 (fewer matmul passes) with comparable SNR; pass
        two_stage=True to select it explicitly."""
        return DFT(self.nfft, two_stage=two_stage)

    def bins_array(self) -> Optional[jax.Array]:
        if self.bins is None:
            return None
        return jnp.asarray(np.asarray(self.bins, dtype=np.int32))

    def frames_per_block(self, block_len: int) -> int:
        assert block_len % self.nfft == 0, \
            "engine must pick block_len commensurate with nfft"
        return block_len // self.nfft


def pfb_spare_init(cfg: PFBConfig, dtype=jnp.float32) -> C:
    """Initial raw-sample carry: (avg-1)*nfft zeros.

    The reference's first block instead loses its first `avg` frames (its
    carry starts empty and batching starts short); zero-priming shifts the
    startup transient into the first avg-1 frames without changing the
    steady state.
    """
    return cplx.zeros((cfg.avg - 1) * cfg.nfft, dtype=dtype)


def pfb_frames(cfg: PFBConfig, window: jax.Array, dft: DFT, spare: C, x: C):
    """One block of the PFB channelizer.

    Args:
      window: (nfft*avg,) real prototype window (cfg.window()).
      dft:    batched DFT op of length nfft (cfg.dft()).
      spare:  ((avg-1)*nfft,) carried raw samples (C pair).
      x:      (L,) input block (C pair), L % nfft == 0.

    Returns:
      (new_spare, frames) with frames of shape (L//nfft, nfft) — the full
      complex spectrum per frame (before tone selection / averaging).
    """
    nfft, avg = cfg.nfft, cfg.avg
    L = x.shape[0]
    nframes = L // nfft
    ze = cplx.concat([spare, x]) if spare.shape[0] else x
    X = ze.reshape(nframes + avg - 1, nfft)
    W = window.reshape(avg, nfft)
    pre = cplx.zeros((nframes, nfft), dtype=x.dtype)
    for i in range(avg):
        pre = pre + cplx.scale(X[i:i + nframes, :], W[i][None, :])
    frames = dft(pre)
    new_spare = ze[L:] if spare.shape[0] else spare
    return new_spare, frames


def select_tones(frames: C, bins: jax.Array) -> C:
    """Gather selected FFT bins: (T, nfft) -> (T, n_tones)
    (reference tone_select, cpp/kernels.cu:531-554)."""
    return cplx.take(frames, bins, axis=-1)


def average_frames(frames: C, decim: int) -> C:
    """Average groups of `decim` consecutive frames
    (reference decimate_spectra, cpp/kernels.cu:726-749).  The engine
    guarantees frames.shape[0] % decim == 0."""
    T, nfft = frames.shape
    return C(frames.re.reshape(T // decim, decim, nfft).mean(axis=1),
             frames.im.reshape(T // decim, decim, nfft).mean(axis=1))
