"""DSP ops (plain JAX, compiled by XLA).

Every op in this package is a pure, jittable function over static shapes.
Streaming state (FIR tails, PFB spare samples, phase accumulators) is passed
explicitly and returned updated, so ops compose under ``jax.lax.scan`` and
shard under ``jax.sharding``/``shard_map``.

Complex data is represented as float32 (re, im) pairs (:mod:`.cplx`):
a complex matmul is 3 real matmuls, a DFT a matmul against precomputed
factor matrices.

Numerical contract: each op matches its golden numpy model in
:mod:`gpu_sdr.golden` (which mirrors the reference CUDA math) to the SNR
bound documented in its tests.
"""

from . import cplx  # noqa: F401
from .cplx import C, DFT  # noqa: F401
from .ddc import DirectDDCConfig, direct_ddc_fir, ddc_carrier_init, ddc_carrier_step  # noqa: F401
from .fir import fir_taps_direct, streaming_fir, fir_init_state  # noqa: F401
from .pfb import PFBConfig, pfb_frames, pfb_spare_init, tone_bins  # noqa: F401
from .chirp import ChirpConfig, chirp_block, chirp_demod_block  # noqa: F401
from .tonegen import ToneCombConfig, tone_comb_block, tone_comb_wavetable  # noqa: F401
from .lockin import lockin_decimate, lockin_profile  # noqa: F401
from .windows import sinc_window, hamming_window, flat_window  # noqa: F401
