"""Sharded PFB parity tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.ops import cplx
from gpu_sdr.ops.pfb import PFBConfig
from gpu_sdr.parallel import make_mesh
from gpu_sdr.parallel.sharded_pfb import ShardedPFB

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("mesh_shape,axes", [
    ((2, 4), ("time", "channels")),
    ((4, 2), ("time", "channels")),
    ((1, 8), ("time", "channels")),
])
def test_sharded_pfb_matches_golden(mesh_shape, axes):
    nfft, avg, rate = 64, 4, 64_000
    L = nfft * 80
    cfg = PFBConfig(nfft=nfft, avg=avg, rate=rate)
    mesh = make_mesh(mesh_shape, axes)
    sp = ShardedPFB(cfg, mesh, L)
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L))
              .astype(np.complex64) for _ in range(3)]
    carry = sp.init_state()
    outs = []
    for b in blocks:
        carry, frames = sp.step(carry, sp.shard_input(b))
        outs.append(cplx.to_np(frames))
    out = np.concatenate(outs, axis=0)
    ref = golden.pfb_frames(np.concatenate(blocks), nfft, avg)
    skip = avg - 1     # zero-primed halo transient
    n = min(len(ref), len(out) - skip)
    snr = golden.snr_db(ref[:n], out[skip:skip + n])
    assert snr > 85.0, f"SNR {snr:.1f} dB (mesh {mesh_shape})"


def test_sharded_pfb_tone_select_gather():
    """Tone selection as a plain gather on the sharded spectrum."""
    nfft, avg, rate = 64, 4, 64_000
    L = nfft * 64
    k = 7
    n = np.arange(2 * L, dtype=np.int64)
    x = np.exp(2j * np.pi * (k * rate // nfft) * n / rate
               ).astype(np.complex64)
    cfg = PFBConfig(nfft=nfft, avg=avg, rate=rate)
    mesh = make_mesh((2, 4), ("time", "channels"))
    sp = ShardedPFB(cfg, mesh, L)
    carry = sp.init_state()
    carry, f1 = sp.step(carry, sp.shard_input(x[:L]))
    carry, f2 = sp.step(carry, sp.shard_input(x[L:]))
    sel = cplx.take(f2, jnp.asarray([k, (k + 9) % nfft]), axis=-1)
    mags = np.abs(cplx.to_np(sel))
    assert mags[:, 0].mean() > 1e3 * mags[:, 1].mean()


def test_sharded_pfb_cross_block_carry_matches_golden():
    """Three blocks through a (2, 4) mesh: golden parity incl. the
    ppermute halo and the cross-block carry."""
    nfft, avg, rate = 64, 4, 64_000
    L = nfft * 80
    cfg = PFBConfig(nfft=nfft, avg=avg, rate=rate)
    mesh = make_mesh((2, 4), ("time", "channels"))
    sp = ShardedPFB(cfg, mesh, L)
    blocks = [(RNG.standard_normal(L) + 1j * RNG.standard_normal(L))
              .astype(np.complex64) for _ in range(3)]
    carry = sp.init_state()
    outs = []
    for b in blocks:
        carry, frames = sp.step(carry, sp.shard_input(b))
        outs.append(cplx.to_np(frames))
    out = np.concatenate(outs, axis=0)
    ref = golden.pfb_frames(np.concatenate(blocks), nfft, avg)
    skip = avg - 1
    n = min(len(ref), len(out) - skip)
    snr = golden.snr_db(ref[:n], out[skip:skip + n])
    assert snr > 85.0, f"SNR {snr:.1f} dB"
