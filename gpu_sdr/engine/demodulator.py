"""RX block demodulator factory.

Equivalent of the reference ``RX_buffer_demodulator``
(cpp/USRP_demodulator.cpp): the constructor switch on wave_type becomes a
factory returning a :class:`Demodulator` whose jitted ``step(state, block)``
is driven over the IQ stream.  All per-mode GPU allocations and bookkeeping
helpers of the reference collapse into the carried state pytree.

Conventions:
  * complex data crosses the device boundary as float32 (re, im) pairs
    (ops/cplx.C) — see ops/cplx.py for why;
  * every mode emits a (out_rows, n_channels) array per block (sample-major,
    channel-minor — the reference's "transposed" interleaved layout,
    cpp/USRP_demodulator.cpp:422-433, which is also the TCP wire order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import AntennaParams, WaveType, chirp_steps_and_length
from ..ops import chirp as chirp_ops
from ..ops import cplx
from ..ops import ddc as ddc_ops
from ..ops import lockin as lockin_ops
from ..ops import pfb as pfb_ops
from ..ops.cplx import C
from .planner import BlockPlan, plan_blocks


@dataclasses.dataclass
class Demodulator:
    """A compiled streaming demodulator for one antenna.

    Attributes:
      plan:       block geometry (static shapes).
      n_channels: output channels per row.
      init_state: () -> carried-state pytree.
      step:       (state, block: C) -> (state, out: C) — jit-compiled.
    """

    plan: BlockPlan
    n_channels: int
    init_state: Callable[[], Any]
    step: Callable[[Any, C], Tuple[Any, C]]
    wave_type: WaveType

    def run(self, blocks) -> np.ndarray:
        """Convenience: demodulate an iterable of numpy complex blocks and
        concatenate the outputs (testing / offline use)."""
        state = self.init_state()
        outs = []
        for b in blocks:
            state, y = self.step(state, cplx.from_np(b))
            outs.append(cplx.to_np(y))
        return np.concatenate(outs, axis=0)


# ----------------------------------------------------------------------
# Mode builders
# ----------------------------------------------------------------------

def _build_direct(p: AntennaParams, plan: BlockPlan) -> Demodulator:
    """DIRECT: fused multi-tone DDC + decimating FIR
    (reference process_direct, cpp/USRP_demodulator.cpp:400-464)."""
    freqs = tuple(int(f) for f in p.freq)
    cfg = ddc_ops.DirectDDCConfig(
        rate=int(p.rate), decim=int(p.decim), pf_average=int(p.pf_average),
        freqs=freqs, phases=(0,) * len(freqs))
    L = plan.block_len
    nb = L // cfg.M
    ramp = cfg.carrier_ramp(nb)
    step_v = ddc_ops.ddc_carrier_step(cfg, L)

    def init_state():
        return (ddc_ops.ddc_carrier_init(cfg, L),
                cplx.zeros((cfg.f - 1) * cfg.M))

    hmod = cfg.modulated_taps()

    @jax.jit
    def step(state, x):
        phase, hist = state
        phase, hist, y = ddc_ops.direct_ddc_fir(
            hmod, ramp, step_v, cfg.rate, cfg.M, cfg.f, phase, hist, x)
        return (phase, hist), y

    return Demodulator(plan=plan, n_channels=len(freqs),
                       init_state=init_state, step=step,
                       wave_type=WaveType.DIRECT)


def _build_pfb(p: AntennaParams, plan: BlockPlan,
               full_spectrum: bool) -> Demodulator:
    """TONES (channelizer + tone select) / NOISE (full spectrum)
    (reference process_pfb / process_pfb_spec,
    cpp/USRP_demodulator.cpp:486-649)."""
    nfft, avg = int(p.fft_tones), int(p.pf_average)
    bins = None if full_spectrum else tuple(
        int(b) for b in pfb_ops.tone_bins(p.freq, p.rate, nfft))
    cfg = pfb_ops.PFBConfig(nfft=nfft, avg=avg, rate=int(p.rate),
                            bins=bins, decim=int(p.decim))
    window = cfg.window()
    # two-stage DFT for larger banks; for tone-select (non-full-spectrum)
    # the scrambled transpose-free variant folds the bin permutation into
    # the gather
    use_two_stage = nfft >= 512
    dft_obj = cfg.dft(two_stage=True if use_two_stage else None)
    if not full_spectrum and dft_obj.split is not None:
        dft = dft_obj.scrambled
        bins_arr = jnp.asarray(dft_obj.scramble_index(bins))
    else:
        dft = dft_obj
        bins_arr = cfg.bins_array()
    decim = int(p.decim)

    def init_state():
        return pfb_ops.pfb_spare_init(cfg)

    @jax.jit
    def step(spare, x):
        spare, frames = pfb_ops.pfb_frames(cfg, window, dft, spare, x)
        if decim > 0:
            frames = pfb_ops.average_frames(frames, decim)
        if bins_arr is not None:
            frames = pfb_ops.select_tones(frames, bins_arr)
        return spare, frames

    n_ch = nfft if full_spectrum else len(bins)
    return Demodulator(plan=plan, n_channels=n_ch,
                       init_state=init_state, step=step,
                       wave_type=WaveType.NOISE if full_spectrum
                       else WaveType.TONES)


def _build_chirp(p: AntennaParams, plan: BlockPlan) -> Demodulator:
    """CHIRP: integer-phase chirp mix-down + lock-in segment average
    (reference process_chirp, cpp/USRP_demodulator.cpp:342-397)."""
    steps, length = chirp_steps_and_length(p)
    cfg = chirp_ops.ChirpConfig.from_params(
        p.freq[0], p.chirp_f[0], int(p.rate), steps, p.chirp_t[0])
    decim = int(p.decim)
    if decim > 0:
        ppt = length * decim
        profile = jnp.asarray(lockin_ops.lockin_profile(ppt))

        @jax.jit
        def step(last, x):
            last, z = chirp_ops.chirp_demod_block(cfg, last, x)
            y = lockin_ops.lockin_decimate(profile, z)
            return last, C(y.re[:, None], y.im[:, None])
    else:
        @jax.jit
        def step(last, x):
            last, z = chirp_ops.chirp_demod_block(cfg, last, x)
            return last, C(z.re[:, None], z.im[:, None])

    return Demodulator(plan=plan, n_channels=1,
                       init_state=lambda: jnp.uint32(0), step=step,
                       wave_type=WaveType.CHIRP)


def _build_nodsp(p: AntennaParams, plan: BlockPlan) -> Demodulator:
    """NODSP: raw passthrough (reference process_nodsp,
    cpp/USRP_demodulator.cpp:335-339)."""

    @jax.jit
    def step(state, x):
        return state, C(x.re[:, None], x.im[:, None])

    return Demodulator(plan=plan, n_channels=1,
                       init_state=lambda: (), step=step,
                       wave_type=WaveType.NODSP)


def _mesh_plan(plan: BlockPlan, mesh, extra_stride: int) -> BlockPlan:
    """Round the block length down to a multiple of (time shards * stride)
    so time segments split evenly."""
    t = mesh.shape.get("time", 1)
    q = plan.stride * t * max(1, extra_stride)
    block = max(q, (plan.block_len // q) * q)
    import math
    n_blocks = max(1, math.ceil(plan.total_samples / block))
    return BlockPlan(block_len=block, stride=plan.stride,
                     out_rows=block // plan.stride, n_blocks=n_blocks,
                     total_samples=n_blocks * block)


def _build_direct_sharded(p: AntennaParams, plan: BlockPlan,
                          mesh) -> Demodulator:
    """DIRECT mode over a (time, channels) mesh: channel-sharded modulated
    taps + time-sharded blocks with halo exchange (parallel/sharded)."""
    from ..parallel.sharded import ShardedDDC
    plan = _mesh_plan(plan, mesh, 1)
    freqs = tuple(int(f) for f in p.freq)
    Cg = len(freqs)
    # the channel mesh axis splits the tone list evenly; pad with dummy
    # DC tones when it doesn't (e.g. a small mixed-mode group) and slice
    # the padding off the output — the dummies cost one lane group each
    Kc = mesh.shape.get("channels", 1)
    pad = (-Cg) % Kc
    cfg = ddc_ops.DirectDDCConfig(
        rate=int(p.rate), decim=int(p.decim), pf_average=int(p.pf_average),
        freqs=freqs + (0,) * pad, phases=(0,) * (Cg + pad))
    sd = ShardedDDC(cfg, mesh, plan.block_len)

    def step(state, x):
        state, y = sd.step(state, x)
        return state, (C(y.re[:, :Cg], y.im[:, :Cg]) if pad else y)

    return Demodulator(plan=plan, n_channels=Cg,
                       init_state=sd.init_state, step=step,
                       wave_type=WaveType.DIRECT)


def _build_tones_sharded(p: AntennaParams, plan: BlockPlan,
                         mesh) -> Demodulator:
    """TONES over a (time, channels) mesh: the sharded PFB computes the
    column-sharded spectrum and selects tones owner-locally inside the SPMD
    program — each channel shard owns nfft/Kc contiguous bins, so selection
    is one local gather plus one psum over the channel axis (no sharded
    gather collective)."""
    from ..parallel.sharded_pfb import ShardedPFB
    nfft = int(p.fft_tones)
    # plan.stride (mode_stride) is already nfft*decim, which makes each
    # time shard's frame count divisible by decim — an extra decim
    # factor here would square it and force absurd block lengths
    plan = _mesh_plan(plan, mesh, 1)
    bins = pfb_ops.tone_bins(p.freq, p.rate, nfft)
    cfg = pfb_ops.PFBConfig(nfft=nfft, avg=int(p.pf_average),
                            rate=int(p.rate))
    sp = ShardedPFB(cfg, mesh, plan.block_len,
                    bins=tuple(int(b) for b in bins))
    decim = int(p.decim)

    def step(state, x):
        # selection commutes with frame averaging (both linear): select
        # owner-locally first, then average the (ft, n_tones) stream
        state, sel = sp.step(state, x)
        if decim > 0:
            sel = pfb_ops.average_frames(sel, decim)
        return state, sel

    return Demodulator(plan=plan, n_channels=len(bins),
                       init_state=sp.init_state, step=step,
                       wave_type=WaveType.TONES)


def _build_chirp_sharded(p: AntennaParams, plan: BlockPlan,
                         mesh) -> Demodulator:
    """CHIRP lock-in over a time mesh (no halo needed: the mix-down is
    elementwise and lock-in segments are shard-local)."""
    from ..parallel.sharded_chirp import ShardedChirpLockin
    if sum(1 for x in p.wave_type if x == WaveType.CHIRP) > 1:
        raise NotImplementedError(
            "Multiple chirp demodulation not implemented "
            "(matches reference)")
    if p.decim <= 0:
        raise NotImplementedError(
            "sharded CHIRP requires lock-in decimation (decim >= 1)")
    steps, length = chirp_steps_and_length(p)
    cfg = chirp_ops.ChirpConfig.from_params(
        p.freq[0], p.chirp_f[0], int(p.rate), steps, p.chirp_t[0])
    ppt = length * int(p.decim)
    plan = _mesh_plan(plan, mesh, 1)
    sc = ShardedChirpLockin(cfg, mesh, plan.block_len, ppt)

    def step(state, x):
        state, y = sc.step(state, x)
        return state, C(y.re[:, None], y.im[:, None])

    return Demodulator(plan=plan, n_channels=1,
                       init_state=sc.init_state, step=step,
                       wave_type=WaveType.CHIRP)


def _build_noise_sharded(p: AntennaParams, plan: BlockPlan,
                         mesh) -> Demodulator:
    """NOISE (full-spectrum PFB) over a (time, channels) mesh."""
    from ..parallel.sharded_pfb import ShardedPFB
    plan = _mesh_plan(plan, mesh, 1)
    cfg = pfb_ops.PFBConfig(nfft=int(p.fft_tones), avg=int(p.pf_average),
                            rate=int(p.rate))
    sp = ShardedPFB(cfg, mesh, plan.block_len)
    decim = int(p.decim)

    def step(state, x):
        state, frames = sp.step(state, x)
        if decim > 0:
            # frame averaging; the mesh-adjusted plan guarantees each time
            # shard holds a whole number of decim-groups
            frames = pfb_ops.average_frames(frames, decim)
        return state, frames

    return Demodulator(plan=plan, n_channels=int(p.fft_tones),
                       init_state=sp.init_state, step=step,
                       wave_type=WaveType.NOISE)


@dataclasses.dataclass
class MixedGroup:
    """One homogeneous sub-stream of a mixed-mode antenna."""

    wave_type: WaveType
    channel_idx: Tuple[int, ...]    # original positions in p.freq
    demod: Demodulator              # shares the common block geometry
    params: AntennaParams           # the homogeneous sub-antenna


@dataclasses.dataclass
class MixedDemodulator:
    """Parallel demodulators over the same block — one per wave type.

    The reference REJECTS mixed wave types on one antenna
    (cpp/USRP_demodulator.cpp:36-39); here each homogeneous group runs
    its own demodulator inside ONE jitted step on a common
    lcm-commensurate block, so e.g. TONES readout and a CHIRP sweep share
    one RX stream.  ``step(states, x) -> (states, tuple_of_outputs)``;
    output g has the group's own (rows_g, C_g) geometry.  H5 layout:
    group 0 writes the standard `data` dataset, group k>0 a
    `mixed_<k>` dataset with wave_type/channel_index attrs
    (client/files.H5Sink, openH5file(dataset=...)).
    """

    plan: BlockPlan                 # common geometry (stride = lcm)
    groups: Tuple[MixedGroup, ...]
    init_state: Callable[[], Any]
    step: Callable[[Any, C], Tuple[Any, Tuple[C, ...]]]
    wave_type: WaveType = WaveType.NODSP

    @property
    def n_channels(self) -> int:
        return sum(g.demod.n_channels for g in self.groups)


def _build_for(p: AntennaParams, plan: BlockPlan, w: WaveType, mesh=None):
    if mesh is not None:
        return _build_for_sharded(p, plan, w, mesh)
    if w == WaveType.DIRECT:
        return _build_direct(p, plan)
    if w == WaveType.TONES:
        return _build_pfb(p, plan, full_spectrum=False)
    if w == WaveType.NOISE:
        return _build_pfb(p, plan, full_spectrum=True)
    if w == WaveType.CHIRP:
        return _build_chirp(p, plan)
    if w == WaveType.NODSP:
        return _build_nodsp(p, plan)
    raise NotImplementedError(f"demodulation for {w} not implemented")


def _build_for_sharded(p: AntennaParams, plan: BlockPlan, w: WaveType,
                       mesh):
    if w == WaveType.DIRECT:
        return _build_direct_sharded(p, plan, mesh)
    if w == WaveType.NOISE:
        return _build_noise_sharded(p, plan, mesh)
    if w == WaveType.TONES:
        return _build_tones_sharded(p, plan, mesh)
    if w == WaveType.CHIRP:
        return _build_chirp_sharded(p, plan, mesh)
    raise NotImplementedError(
        f"sharded demodulation for {w} not implemented yet")


def _build_mixed(p: AntennaParams, samples, mesh=None) -> MixedDemodulator:
    """Partition the channel list by wave type and run every group's
    demodulator on the same block inside one jitted step.  With `mesh`,
    every group runs its SHARDED demodulator over the same time-sharded
    block (the block length is made commensurate with every group's
    per-shard stride constraints)."""
    import math

    from .planner import (_commensurate, mode_stride)
    order: list[WaveType] = []
    members: dict[WaveType, list[int]] = {}
    for i, w in enumerate(p.wave_type):
        if w not in members:
            members[w] = []
            order.append(w)
        members[w].append(i)

    n_all = len(p.wave_type)

    def _sub(lst, idx):
        """Subset a parallel per-channel list; lists shorter than the
        channel count (e.g. one chirp_f for the single CHIRP channel) are
        taken in listed order."""
        if not lst:
            return []
        if len(lst) == n_all:
            return [lst[i] for i in idx]
        return list(lst[:len(idx)])

    subs = []
    for w in order:
        idx = members[w]
        sub = dataclasses.replace(
            p,
            freq=_sub(p.freq, idx),
            wave_type=[w] * len(idx),
            ampl=_sub(p.ampl, idx),
            chirp_f=_sub(p.chirp_f, idx) if w == WaveType.CHIRP
            else list(p.chirp_f or []),
            chirp_t=_sub(p.chirp_t, idx) if w == WaveType.CHIRP
            else list(p.chirp_t or []),
            swipe_s=_sub(p.swipe_s, idx) if w == WaveType.CHIRP
            else list(p.swipe_s or []))
        if w == WaveType.CHIRP and len(idx) > 1:
            raise NotImplementedError(
                "Multiple chirp demodulation not implemented "
                "(matches reference)")
        subs.append((w, tuple(idx), sub))

    # common block: the lcm of every group's stride, near buffer_len.
    # Under a mesh the block must additionally split evenly across the
    # time shards at every group's stride (and the sharded TONES path's
    # extra per-shard decim-grouping constraint, cf. _build_tones_sharded)
    q = 1
    t_shards = mesh.shape.get("time", 1) if mesh is not None else 1
    for w, _idx, sub in subs:
        q = math.lcm(q, mode_stride(sub))
    qc = q * t_shards
    from ..params import DEFAULT_BUFFER_LEN
    block = _commensurate(p.buffer_len or DEFAULT_BUFFER_LEN, qc)
    total = int(samples if samples is not None else p.samples)
    if total <= 0:
        total = block
    n_blocks = max(1, math.ceil(total / block))

    groups = []
    for w, idx, sub in subs:
        sg = mode_stride(sub)
        gplan = BlockPlan(block_len=block, stride=sg,
                         out_rows=block // sg, n_blocks=n_blocks,
                         total_samples=n_blocks * block)
        gd = _build_for(sub, gplan, w, mesh=mesh)
        assert gd.plan.block_len == block, (w, gd.plan.block_len, block)
        groups.append(MixedGroup(wave_type=w, channel_idx=idx,
                                 demod=gd, params=sub))

    def init_state():
        return tuple(g.demod.init_state() for g in groups)

    @jax.jit
    def step(states, x):
        new_states, outs = [], []
        for g, st in zip(groups, states):
            st, y = g.demod.step(st, x)
            new_states.append(st)
            outs.append(y)
        return tuple(new_states), tuple(outs)

    plan = BlockPlan(block_len=block, stride=q, out_rows=block // q,
                     n_blocks=n_blocks, total_samples=n_blocks * block)
    return MixedDemodulator(plan=plan, groups=tuple(groups),
                            init_state=init_state, step=step)


def make_demodulator(p: AntennaParams, samples: int | None = None,
                     mesh=None) -> Demodulator:
    """Build the streaming demodulator for one RX antenna (the factory
    switch of the reference ctor, cpp/USRP_demodulator.cpp:56-326).

    With `mesh` (a jax.sharding.Mesh with 'time'/'channels' axes), all
    four demod families run multi-chip with halo exchange.  Mixed
    wave types on one antenna run parallel per-type demodulators over the
    same block (a capability the reference rejects,
    cpp/USRP_demodulator.cpp:36-39), including under a mesh — each group
    runs its sharded demodulator on the same time-sharded block."""
    w = p.wave_type[0] if p.wave_type else WaveType.NODSP
    if any(x != w for x in p.wave_type):
        return _build_mixed(p, samples, mesh=mesh)
    plan = plan_blocks(p, samples)
    if mesh is not None:
        return _build_for_sharded(p, plan, w, mesh)
    if w == WaveType.DIRECT:
        return _build_direct(p, plan)
    if w == WaveType.TONES:
        return _build_pfb(p, plan, full_spectrum=False)
    if w == WaveType.NOISE:
        return _build_pfb(p, plan, full_spectrum=True)
    if w == WaveType.CHIRP:
        if sum(1 for x in p.wave_type if x == WaveType.CHIRP) > 1:
            raise NotImplementedError(
                "Multiple chirp demodulation not implemented "
                "(matches reference)")
        return _build_chirp(p, plan)
    if w == WaveType.NODSP:
        return _build_nodsp(p, plan)
    raise NotImplementedError(f"demodulation for {w} not implemented")
