"""Fused TX->PFB->select loopback chain over a (time, channels) mesh.

The multi-chip form of engine/fused.py's TONES->TONES path: the whole
K-blocks-per-execution loop — tone synthesis, PFB channelization, tone
selection — runs as ONE SPMD program.  The `lax.scan` lives *inside* the
`shard_map`, so each device executes the full K-block loop locally and the
only inter-device traffic per block is

  * a ppermute of the (avg-1)*nfft-sample overlap-save halo around the
    time ring (neighbour exchange; the reference's buffer_helper spare
    samples, cpp/USRP_server_memory_management.cpp:104-156), and
  * one psum over the channel axis to combine owner-local tone selections
    (each channel shard owns nfft/Kc contiguous bins and contributes only
    the tones whose bin it owns — no sharded gather, no all-to-all).

TX synthesis shards over 'time' exactly: per-shard integer phase offsets
f*(t*Lt) mod W are folded into the per-shard int32 phase carry (the general
matmul comb), or — for bin-quantized combs with period | block — the local
block slice is a constant (the wavetable fast path, see ops/tonegen.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import cplx
from ..ops import tonegen as tone_ops
from ..ops.cplx import C
from ..ops.pfb import PFBConfig, tone_bins
from ..params import AntennaParams, WaveType


def _cpair(*spec):
    return C(P(*spec), P(*spec))


def _to_np_global(ys: C) -> np.ndarray:
    """Global numpy view of a sharded result; on a multi-process (multi-
    host) mesh the shards are gathered with process_allgather so every
    host's sinks see the full stream (the per-host ingest/egress design
    of SURVEY.md section 7)."""
    re, im = ys.re, ys.im
    if hasattr(re, "is_fully_addressable") and not re.is_fully_addressable:
        from jax.experimental import multihost_utils
        re = multihost_utils.process_allgather(re, tiled=True)
        im = multihost_utils.process_allgather(im, tiled=True)
        return np.asarray(re).astype(np.float32) + \
            1j * np.asarray(im).astype(np.float32)
    return cplx.to_np(ys)


@dataclasses.dataclass
class ShardedFusedLoopback:
    """Compiled sharded K-block TONES->TONES (PFB) loopback chain.

    Usage:
        sf = ShardedFusedLoopback(tx, rx, mesh, blocks_per_exec=K,
                                  block_len=L)
        state = sf.init_state()
        state, ys = sf.run_exec(state)    # ys (K, L//nfft, n_tones) global
    """

    tx: AntennaParams
    rx: AntennaParams
    mesh: Mesh
    blocks_per_exec: int = 8
    block_len: int = 1_000_000

    def __post_init__(self):
        tx, rx, mesh, L = self.tx, self.rx, self.mesh, self.block_len
        assert tx.wave_type and tx.wave_type[0] == WaveType.TONES
        assert rx.wave_type and rx.wave_type[0] == WaveType.TONES
        rate = int(rx.rate)
        nfft = int(rx.fft_tones)
        avg = int(rx.pf_average)
        self.cfg = PFBConfig(nfft=nfft, avg=avg, rate=rate)
        self.T = mesh.shape.get("time", 1)
        self.Kc = mesh.shape.get("channels", 1)
        assert L % (self.T * nfft) == 0, \
            "block_len must split over time shards in whole frames"
        assert nfft % self.Kc == 0, "nfft must split over channel shards"
        self.Lt = L // self.T
        self.ft = self.Lt // nfft            # frames per time shard
        self.H = (avg - 1) * nfft
        assert self.H <= self.Lt, "halo must fit in one time shard"

        # tone selection: owner shard + local column per tone
        bins = tone_bins(rx.freq, rate, nfft)          # global bins
        nloc = nfft // self.Kc
        self.n_tones = len(bins)
        self._bins_np = np.asarray(bins)
        self._owners = jnp.asarray((bins // nloc).astype(np.int32))
        self._local_idx = jnp.asarray((bins % nloc).astype(np.int32))

        from ..ops.cplx import dft_matrix
        self.F = dft_matrix(nfft)                      # (nfft, nfft)
        self.window = self.cfg.window()

        # TX path selection (mirrors engine/generator.py make_generator)
        freqs = tuple(int(f) for f in tx.freq)
        ampls = tuple(float(a) for a in (tx.ampl or [1.0] * len(freqs)))
        period = tone_ops.comb_period(freqs, rate)
        self._const_tx = (L % period == 0 and period <= (1 << 22))
        if self._const_tx:
            self._xconst = tone_ops.tone_comb_wavetable_block(
                freqs, ampls, rate, L)                 # (L,) global const
        else:
            cfgt = tone_ops.ToneCombConfig(
                rate=rate, freqs=freqs, ampls=ampls, block_len=self.Lt)
            self._P, self._Q = cfgt.factors()          # local (U,C),(C,S)
            fr = np.asarray(freqs, dtype=np.int64)
            W = rate
            # per-block phase advance is the GLOBAL block stride f*L mod W
            self._stepv = jnp.asarray(((fr * L) % W).astype(np.int32))
            # per-shard init: shard t starts at absolute sample t*Lt
            t = np.arange(self.T, dtype=np.int64)
            ph0 = (fr[None, :] * ((t[:, None] * self.Lt) % W)) % W
            self._phase0 = jnp.asarray(
                ph0.reshape(-1).astype(np.int32))      # (T*Ctx,)
            self._n_tx = len(freqs)
        # dispatch sub-path (plan==actual battery)
        self.path = "pfb_scan"
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        mesh = self.mesh
        nfft, avg = self.cfg.nfft, self.cfg.avg
        rate = self.cfg.rate
        T, H, ft, K = self.T, self.H, self.ft, self.blocks_per_exec
        Kc = self.Kc
        has_time = "time" in mesh.axis_names and T > 1
        time_ax = "time" if "time" in mesh.axis_names else None
        ch_ax = "channels" if "channels" in mesh.axis_names else None
        const_tx = self._const_tx

        def pfb_select(halo, x, window, F, owners, local_idx):
            """One block of PFB + owner-local select (local shapes:
            halo (H,), x (Lt,), F (nfft, nfft/Kc))."""
            if H > 0 and has_time:
                tail = x[-H:]
                perm = [(i, (i + 1) % T) for i in range(T)]
                recv = C(jax.lax.ppermute(tail.re, "time", perm),
                         jax.lax.ppermute(tail.im, "time", perm))
                tidx = jax.lax.axis_index("time")
                use = C(jnp.where(tidx == 0, halo.re, recv.re),
                        jnp.where(tidx == 0, halo.im, recv.im))
                new_halo = recv
            elif H > 0:
                use, new_halo = halo, x[-H:]
            else:
                use, new_halo = halo, halo
            W2 = window.reshape(avg, nfft)
            ze = cplx.concat([use, x]) if H else x
            X = ze.reshape(ft + avg - 1, nfft)
            pre = cplx.zeros((ft, nfft), dtype=x.re.dtype)
            for i in range(avg):
                pre = pre + cplx.scale(X[i:i + ft, :], W2[i][None, :])
            frames = cplx.matmul(pre, F)               # (ft, nfft/Kc)
            sel = cplx.take(frames, local_idx, axis=-1)  # (ft, n_tones)
            if ch_ax is not None and Kc > 1:
                cidx = jax.lax.axis_index("channels")
                mask = (owners == cidx).astype(sel.re.dtype)[None, :]
                sel = C(jax.lax.psum(sel.re * mask, "channels"),
                        jax.lax.psum(sel.im * mask, "channels"))
            return new_halo, sel

        if const_tx:
            def spmd_chain(halo, xloc, window, F, owners, local_idx):
                def body(carry, _):
                    halo2, sel = pfb_select(carry, xloc, window, F,
                                            owners, local_idx)
                    return halo2, sel
                halo, ys = jax.lax.scan(body, halo, None, length=K)
                return halo, ys

            self._exec = jax.jit(shard_map(
                spmd_chain, mesh=mesh,
                in_specs=(_cpair(time_ax),     # halo carry
                          _cpair(time_ax),     # const TX block
                          P(None),             # window
                          _cpair(None, ch_ax),  # DFT columns
                          P(None), P(None)),   # owners, local_idx
                out_specs=(_cpair(time_ax),
                           _cpair(None, time_ax, None)),
                check_vma=False))
        else:
            Ptx, Qtx, stepv = self._P, self._Q, self._stepv

            def spmd_chain(phase, halo, window, F, owners, local_idx):
                def body(carry, _):
                    ph, hl = carry
                    ph, x = tone_ops.tone_comb_block(Ptx, Qtx, stepv,
                                                     rate, ph)
                    hl, sel = pfb_select(hl, x, window, F,
                                         owners, local_idx)
                    return (ph, hl), sel
                (phase2, halo2), ys = jax.lax.scan(
                    body, (phase, halo), None, length=K)
                return phase2, halo2, ys

            self._exec = jax.jit(shard_map(
                spmd_chain, mesh=mesh,
                in_specs=(P(time_ax),          # per-shard tx phase
                          _cpair(time_ax),     # halo carry
                          P(None),
                          _cpair(None, ch_ax),
                          P(None), P(None)),
                out_specs=(P(time_ax), _cpair(time_ax),
                           _cpair(None, time_ax, None)),
                check_vma=False))

    # ------------------------------------------------------------------
    def init_state(self):
        halo = cplx.zeros(self.T * self.H)
        if self._const_tx:
            return (halo,)
        return (self._phase0, halo)

    def run_exec(self, state):
        """One compiled execution: K blocks.  Returns (state', ys) with
        ys of global shape (K, L//nfft, n_tones) sharded over time."""
        if self._const_tx:
            (halo,) = state
            halo, ys = self._exec(halo, self._xconst, self.window, self.F,
                                  self._owners, self._local_idx)
            return (halo,), ys
        phase, halo = state
        phase, halo, ys = self._exec(phase, halo, self.window, self.F,
                                     self._owners, self._local_idx)
        return (phase, halo), ys

    # ------------------------------------------------------------------
    def run(self, sinks=(), usrp_number: int = 0, front_end: str = "A",
            n_blocks: int | None = None):
        """Stream a full acquisition through the sharded chain, feeding
        sinks packet-by-packet (the mesh analogue of
        engine/fused.FusedLoopback.run); on a multi-host mesh each host's
        sinks receive the gathered global stream."""
        from ..engine.pipeline import run_chunked
        K = self.blocks_per_exec
        nb = int(n_blocks) if n_blocks else K
        n_exec = max(1, -(-nb // K))
        rows_per_block = self.T * self.ft
        return run_chunked(self.run_exec, self.init_state, n_exec, nb,
                           self.block_len, self.n_tones,
                           rows_per_block * nb, sinks,
                           usrp_number=usrp_number, front_end=front_end,
                           to_np=_to_np_global)


@dataclasses.dataclass
class ShardedFusedVNA:
    """Compiled sharded K-block CHIRP->CHIRP (VNA) loopback chain.

    Chirp demod is elementwise and the lock-in segment-local, so the chain
    needs NO halo (see sharded_chirp.py): each time shard synthesizes its
    own chirp segment from a per-shard uint32 offset (exact mod-period
    arithmetic), mixes it down against itself (the loopback), and reduces
    whole lock-in segments.  The scan over K blocks runs inside the
    shard_map; the only replicated state is the uint32 block-start index.
    """

    tx: AntennaParams
    rx: AntennaParams
    mesh: Mesh
    blocks_per_exec: int = 8
    block_len: int = 1_000_000

    def __post_init__(self):
        from ..params import chirp_steps_and_length
        from ..ops import chirp as chirp_ops
        from ..ops.lockin import lockin_profile
        tx, rx, mesh, L = self.tx, self.rx, self.mesh, self.block_len
        assert tx.wave_type and tx.wave_type[0] == WaveType.CHIRP
        assert rx.wave_type and rx.wave_type[0] == WaveType.CHIRP
        steps, length = chirp_steps_and_length(rx)
        self.cfg = chirp_ops.ChirpConfig.from_params(
            rx.freq[0], rx.chirp_f[0], int(rx.rate), steps, rx.chirp_t[0])
        decim = int(rx.decim)
        assert decim > 0, "sharded fused VNA needs the lock-in (decim>=1)"
        self.ppt = length * decim
        self.T = mesh.shape.get("time", 1)
        assert L % (self.T * self.ppt) == 0, \
            "block must split into whole lock-in segments per time shard"
        self.Lt = L // self.T
        self.nseg_t = self.Lt // self.ppt
        self.scale = float(tx.ampl[0]) if tx.ampl else 1.0
        period = self.cfg.period
        t = np.arange(self.T, dtype=np.uint64)
        self._off = jnp.asarray(
            ((t * np.uint64(self.Lt)) % np.uint64(period)).astype(np.uint32))
        self.profile = jnp.asarray(lockin_profile(self.ppt))
        self.n_tones = 1
        self.path = "chirp_lockin"
        self._build()

    def _build(self):
        from ..ops.chirp import chirp_phase_index
        cfg, mesh = self.cfg, self.mesh
        Lt, ppt, nseg_t, K = self.Lt, self.ppt, self.nseg_t, \
            self.blocks_per_exec
        L = self.block_len
        time_ax = "time" if "time" in mesh.axis_names else None
        period = jnp.uint32(cfg.period)
        scale = jnp.float32(self.scale)

        def spmd_chain(last, off, profile):
            n = jnp.arange(Lt, dtype=jnp.uint32)

            def body(l, _):
                base = (l[0] % period) + off[0]
                base = jnp.where(base >= period, base - period, base)
                idx = chirp_phase_index(cfg, base, n)
                th = jnp.float32(np.pi) * (
                    idx.astype(jnp.float32) *
                    jnp.float32(1.0 / 2147483647.5))
                c = C(jnp.sin(th), -jnp.cos(th))      # unit chirp
                x = C(c.re * scale, c.im * scale)     # TX output
                z = cplx.conj_mul(c, x)               # RX mix-down
                seg = z.reshape(nseg_t, ppt)
                y = cplx.matmul_cr(seg, profile)
                l2 = (l + jnp.uint32(L % cfg.period)) % period
                return l2, y

            last, ys = jax.lax.scan(body, last, None, length=K)
            return last, ys

        self._exec = jax.jit(shard_map(
            spmd_chain, mesh=mesh,
            in_specs=(P(None), P(time_ax), P(None)),
            out_specs=(P(None), _cpair(None, time_ax)),
            check_vma=False))

    # ------------------------------------------------------------------
    def init_state(self):
        return (jnp.zeros(1, dtype=jnp.uint32),)

    def run_exec(self, state):
        """One execution: K blocks -> ys global (K, L//ppt, 1)."""
        (last,) = state
        last, ys = self._exec(last, self._off, self.profile)
        ys = C(ys.re[..., None], ys.im[..., None])
        return (last,), ys

    # reuse the generic acquisition loop
    ft = property(lambda self: self.nseg_t)
    run = ShardedFusedLoopback.run


@dataclasses.dataclass
class ShardedFusedDirect:
    """Sharded K-block TONES->DIRECT loopback — ZERO collectives.

    The shift-fold chain (ops/fold_chain.py) shards embarrassingly: each
    block is y = ((P * srot) @ G2) * ramp * drot with P and the ramp
    depending only on the row within the block, so P/ramp rows split over
    'time', G2/ramp columns over 'channels', and every shard computes its
    own rows from constants — no halo exists to exchange.  Only the time
    shard holding the stream's first f-1 rows applies the zero-history
    startup correction.
    """

    tx: AntennaParams
    rx: AntennaParams
    mesh: Mesh
    blocks_per_exec: int = 8
    block_len: int = 1_000_000

    def __post_init__(self):
        from ..ops.ddc import DirectDDCConfig
        from ..ops.fold_chain import TonesDirectFoldChain
        tx, rx, mesh = self.tx, self.rx, self.mesh
        self.T = mesh.shape.get("time", 1)
        self.Kc = mesh.shape.get("channels", 1)
        freqs = tuple(int(f) for f in tx.freq)
        rx_freqs = tuple(int(f) for f in rx.freq)
        cfg = DirectDDCConfig(rate=int(rx.rate), decim=int(rx.decim),
                              pf_average=int(rx.pf_average),
                              freqs=rx_freqs, phases=(0,) * len(rx_freqs))
        self.chain = ch = TonesDirectFoldChain(
            rate=int(tx.rate), tx_freqs=freqs,
            tx_ampls=tuple(float(a) for a in
                           (tx.ampl or [1.0] * len(freqs))),
            cfg=cfg, block_len=self.block_len)
        self.ok = bool(ch.ok and ch.nb % self.T == 0 and
                       ch.Cp % self.Kc == 0 and
                       ch.nb // self.T >= cfg.f - 1)
        if not self.ok:
            return
        self.path = "fold_chain"          # dispatch sub-path
        self.n_tones = len(rx_freqs)
        self.ft = ch.nb // self.T         # output rows per time shard
        time_ax = "time" if "time" in mesh.axis_names else None
        ch_ax = "channels" if "channels" in mesh.axis_names else None

        has_time = time_ax is not None and self.T > 1
        K = self.blocks_per_exec

        def spmd(sph, dph, pv, Pl, rampl, G2, G2p, sstep, dstep):
            first = (jax.lax.axis_index("time") == 0 if has_time
                     else True)
            return ch.scan_blocks(sph, dph, pv, Pl, rampl, G2, G2p, K,
                                  sstep, dstep, startup=first)

        smapped = shard_map(
            spmd, mesh=mesh,
            in_specs=(P(None), P(ch_ax), P(),
                      _cpair(time_ax, None), _cpair(time_ax, ch_ax),
                      _cpair(None, ch_ax), _cpair(None, None, ch_ax),
                      P(None), P(ch_ax)),
            out_specs=((P(None), P(ch_ax), P()),
                       _cpair(None, time_ax, ch_ax)),
            check_vma=False)

        @jax.jit
        def exec_fn(state):
            sph, dph, pv = state
            return smapped(sph, dph, pv, ch._P, ch._ramp, ch._G2, ch._G2p,
                           ch._sstep, ch._dstep)

        self._exec = exec_fn

    def init_state(self):
        sph, dph, pv, _P, _ramp = self.chain.init_state()
        return (sph, dph, pv)

    def run_exec(self, state):
        """One execution: K blocks -> ys global (K, nb, C)."""
        return self._exec(state)

    # reuse the generic acquisition loop
    run = ShardedFusedLoopback.run


def can_fuse_sharded(tx: AntennaParams | None, rx: AntennaParams,
                     mesh: Mesh) -> bool:
    """True when the (tx, rx, mesh) triple maps onto the sharded fused
    chain: TONES->TONES, no frame averaging, bins splittable over the
    channel axis."""
    if tx is None or not tx.wave_type or not rx.wave_type:
        return False
    pair = (tx.wave_type[0], rx.wave_type[0])
    if pair == (WaveType.TONES, WaveType.TONES):
        if int(rx.decim) > 1:
            return False
        Kc = mesh.shape.get("channels", 1)
        nfft = int(rx.fft_tones)
        return nfft > 0 and nfft % Kc == 0
    if pair == (WaveType.CHIRP, WaveType.CHIRP):
        return int(rx.decim) >= 1 and len(rx.freq) == 1
    if pair == (WaveType.TONES, WaveType.DIRECT):
        Kc = mesh.shape.get("channels", 1)
        return (int(rx.decim) > 0 and int(rx.pf_average) >= 2 and
                tx.burst_on <= 0 and            # chain has no burst gate
                len(tx.freq) > 0 and
                len(rx.freq) > 0 and len(rx.freq) % Kc == 0)
    return False


def make_sharded_fused(tx: AntennaParams, rx: AntennaParams, mesh: Mesh,
                       blocks_per_exec: int, block_len: int):
    """Build the fused sharded chain for a fusable (tx, rx) pair.
    Returns None when the geometry doesn't split over the mesh (callers
    fall back to the non-fused sharded path)."""
    if rx.wave_type[0] == WaveType.CHIRP:
        return ShardedFusedVNA(tx, rx, mesh, blocks_per_exec=blocks_per_exec,
                               block_len=block_len)
    if rx.wave_type[0] == WaveType.DIRECT:
        sf = ShardedFusedDirect(tx, rx, mesh,
                                blocks_per_exec=blocks_per_exec,
                                block_len=block_len)
        return sf if sf.ok else None
    return ShardedFusedLoopback(tx, rx, mesh,
                                blocks_per_exec=blocks_per_exec,
                                block_len=block_len)


def plan_sharded_block(rx: AntennaParams, mesh: Mesh):
    """(block_len, n_blocks) for a sharded fused acquisition: the planner's
    commensurate block rounded up so it splits over time shards in whole
    output strides (frames / lock-in segments) and — for the PFB — each
    shard's segment covers the overlap-save halo."""
    from ..engine.planner import mode_stride, plan_blocks
    plan = plan_blocks(rx)
    T = mesh.shape.get("time", 1)
    q = T * mode_stride(rx)
    L = -(-plan.block_len // q) * q
    if rx.wave_type and rx.wave_type[0] == WaveType.TONES:
        L = max(L, T * (int(rx.pf_average) - 1) * int(rx.fft_tones))
        L = -(-L // q) * q
    total = int(rx.samples) if int(rx.samples) > 0 else L
    return L, max(1, -(-total // L))
