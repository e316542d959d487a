"""Concurrent, time-aligned dual-frontend execution.

The reference runs the A and B frontends as simultaneous thread chains on
one device timebase (TXRX::start spawns both workers against the same
set_time_unknown_pps clock, cpp/USRP_server_link_threads.cpp:249-397), so
dual measurements (correlated noise, Dual_VNA, beam mapping) sample the
same instants on both channels.

On one device the equivalent is ONE jitted program per execution advancing
BOTH frontends' fused chains by the same K blocks: packet k of A and
packet k of B cover exactly the same sample index range [k*L, (k+1)*L) by
construction — XLA schedules the two chains' work inside one program, the
closest thing to "simultaneous" a single accelerator has.  Under a device
mesh the same holds with both chains' shard_maps inlined into one SPMD
program (DualShardedFused).  The sequential fallback (one frontend after
the other) is kept for non-fusable modes and WARNS that the reference's
lock-step timing semantics are degraded.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import jax

from ..ops import cplx
from ..params import AntennaParams
from ..utils.log import get_logger
from .fused import FusedLoopback, can_fuse
from .pipeline import PipelineResult
from .sinks import PacketMeta, Sink

log = get_logger("dual")


def _run_lockstep(multi_all, init_states, n_exec: int, n_blocks: int,
                  block_len: int, channels_per_fe: Sequence[int],
                  rows_total_per_fe: Sequence[int],
                  front_ends: Sequence[str],
                  sinks_per_fe: Sequence[Sequence[Sink]],
                  usrp_number: int, conv) -> List[PipelineResult]:
    """Shared lock-step acquisition loop: per execution ALL frontends
    advance together inside one jitted program, then the previous
    execution's results drain to the sinks (same one-in-flight overlap as
    pipeline.run_chunked)."""
    n_fe = len(front_ends)
    for i, sinks in enumerate(sinks_per_fe):
        for s in sinks:
            s.on_start(channels_per_fe[i], rows_total_per_fe[i])
    states = init_states()
    pkts = [0] * n_fe
    rows = [0] * n_fe
    t0 = time.perf_counter()

    def drain(outs):
        for i, ys in enumerate(outs):
            data = conv(ys)[:max(0, n_blocks - pkts[i])]
            for k in range(data.shape[0]):
                d = data[k]
                meta = PacketMeta(
                    usrp_number=usrp_number,
                    front_end_code=front_ends[i],
                    packet_number=pkts[i], length=int(d.size),
                    errors=0, channels=int(d.shape[1]))
                for s in sinks_per_fe[i]:
                    s.on_packet(meta, d)
                rows[i] += d.shape[0]
                pkts[i] += 1

    pending = None
    for _ in range(n_exec):
        states, outs = multi_all(states)
        if pending is not None:
            drain(pending)
        pending = outs
    if pending is not None:
        drain(pending)
    elapsed = time.perf_counter() - t0
    for sinks in sinks_per_fe:
        for s in sinks:
            s.on_end()
    return [PipelineResult(n_blocks=pkts[i], rows=rows[i],
                           channels=channels_per_fe[i],
                           elapsed_s=elapsed,
                           samples_in=pkts[i] * block_len)
            for i in range(n_fe)]


class DualFused:
    """Two (or more) fused loopback chains advanced in lock-step by one
    jitted program."""

    def __init__(self, pairs: Sequence[Tuple[str, AntennaParams,
                                             AntennaParams]],
                 blocks_per_exec: int = 8):
        assert len(pairs) >= 2
        self.rx_names = [name for name, _tx, _rx in pairs]
        # wire code = the FULL antenna name (A_TXRX/A_RX2/B_TXRX/B_RX2):
        # collapsing to the frontend letter would make e.g. a dual
        # measurement on A_TXRX + A_RX2 indistinguishable on the wire
        # (both streams coded 'A' with colliding packet numbers)
        self.front_ends = list(self.rx_names)
        self.chains = [FusedLoopback(tx, rx, blocks_per_exec=blocks_per_exec)
                       for _fe, tx, rx in pairs]
        self.blocks_per_exec = blocks_per_exec
        p0 = self.chains[0].demod.plan
        for ch in self.chains[1:]:
            p = ch.demod.plan
            assert (p.block_len == p0.block_len and
                    p.n_blocks == p0.n_blocks), \
                "lock-step chains need a common block plan"
        chains = self.chains

        @jax.jit
        def multi_all(states):
            new_states, outs = [], []
            for ch, (g, d) in zip(chains, states):
                g, d, ys = ch._multi(g, d)
                new_states.append((g, d))
                outs.append(ys)
            return new_states, outs

        self._multi_all = multi_all

    def run(self, sinks_per_fe: Sequence[Sequence[Sink]],
            usrp_number: int = 0) -> List[PipelineResult]:
        """Stream both acquisitions; sinks_per_fe[i] receives frontend
        i's packets."""
        plans = [ch.demod.plan for ch in self.chains]
        n_blocks = plans[0].n_blocks
        K = self.blocks_per_exec
        n_exec = max(1, -(-n_blocks // K))
        return _run_lockstep(
            self._multi_all,
            lambda: [ch._init_states() for ch in self.chains],
            n_exec, n_blocks, plans[0].block_len,
            [ch.demod.n_channels for ch in self.chains],
            [ch.demod.plan.total_out_rows for ch in self.chains],
            self.front_ends, sinks_per_fe, usrp_number, cplx.to_np)


class DualShardedFused:
    """Two (or more) SHARDED fused chains advanced in lock-step inside
    ONE SPMD program over the mesh — the multi-chip form of DualFused
    (the reference's simultaneous A/B thread chains on one PPS timebase,
    cpp/USRP_server_link_threads.cpp:249-397).

    Each frontend's scan-inside-shard_map chain
    (parallel/fused_sharded.py) is inlined into one outer jitted program,
    so every execution advances all frontends by the same K blocks on the
    same mesh.  `.ok` is False when the frontends cannot share a mesh
    block plan — callers fall back to sequential streaming (with a
    warning from plan_dual)."""

    def __init__(self, pairs: Sequence[Tuple[str, AntennaParams,
                                             AntennaParams]],
                 mesh, blocks_per_exec: int = 8):
        from ..parallel.fused_sharded import (make_sharded_fused,
                                              plan_sharded_block)
        assert len(pairs) >= 2
        self.mesh = mesh
        self.rx_names = [name for name, _tx, _rx in pairs]
        self.front_ends = list(self.rx_names)
        plans = [plan_sharded_block(rx, mesh) for _n, _tx, rx in pairs]
        self.ok = all(p == plans[0] for p in plans[1:])
        if not self.ok:
            return
        self.block_len, self.n_blocks = plans[0]
        K = min(blocks_per_exec, self.n_blocks)
        self.blocks_per_exec = K
        self.chains = []
        for _n, tx, rx in pairs:
            ch = make_sharded_fused(tx, rx, mesh, blocks_per_exec=K,
                                    block_len=self.block_len)
            if ch is None:         # untileable geometry
                self.ok = False
                return
            self.chains.append(ch)
        chains = self.chains

        @jax.jit
        def multi_all(states):
            new_states, outs = [], []
            for ch, st in zip(chains, states):
                st, ys = ch.run_exec(st)
                new_states.append(st)
                outs.append(ys)
            return new_states, outs

        self._multi_all = multi_all

    def run(self, sinks_per_fe: Sequence[Sequence[Sink]],
            usrp_number: int = 0) -> List[PipelineResult]:
        from ..parallel.fused_sharded import _to_np_global
        K = self.blocks_per_exec
        n_blocks = self.n_blocks
        n_exec = max(1, -(-n_blocks // K))
        return _run_lockstep(
            self._multi_all,
            lambda: [ch.init_state() for ch in self.chains],
            n_exec, n_blocks, self.block_len,
            [ch.n_tones for ch in self.chains],
            [ch.T * ch.ft * n_blocks for ch in self.chains],
            self.front_ends, sinks_per_fe, usrp_number, _to_np_global)


def _sequential(reason: str):
    """The dual plan falls back to one-frontend-after-the-other: warn
    that the reference's lock-step timing semantics are degraded
    (reference runs A/B simultaneously,
    cpp/USRP_server_link_threads.cpp:249-397)."""
    log.warning(
        "dual frontends will stream SEQUENTIALLY (%s): packets of A and "
        "B no longer cover the same sample instants", reason)
    return None


def plan_dual(params, mesh=None) -> Optional[List[Tuple[str, AntennaParams,
                                                        AntennaParams]]]:
    """If the measurement is a multi-frontend fused loopback (>= 2 active
    RX, each with a fusable paired TX, common block plan), return the
    lock-step (rx_name, tx, rx) pairs; else None (sequential path, with a
    warning).  With a mesh, fusability is judged against the sharded
    chains (can_fuse_sharded) and the mesh block planner."""
    from ..measure import _pair_tx
    from ..params import AntMode
    from .planner import plan_blocks
    rxs = list(params.active_antennas(AntMode.RX))
    if len(rxs) < 2:
        return None
    if mesh is not None:
        from ..parallel.fused_sharded import (can_fuse_sharded,
                                              plan_sharded_block)
    pairs = []
    plan0 = None
    for rx_name, rx in rxs:
        if rx.wave_type and any(w != rx.wave_type[0]
                                for w in rx.wave_type):
            return _sequential(f"{rx_name} is mixed-mode")
        tx_name = _pair_tx(params, rx_name)
        tx = params.antenna(tx_name) if tx_name else None
        if tx is None:
            return _sequential(f"{rx_name} has no paired TX")
        fusable = (can_fuse_sharded(tx, rx, mesh) if mesh is not None
                   else can_fuse(tx, rx))
        if not fusable:
            return _sequential(f"{rx_name} mode pair is not fusable")
        if rx.delay > tx.delay:
            return _sequential(f"{rx_name} rx.delay > tx.delay")
        p = (plan_sharded_block(rx, mesh) if mesh is not None
             else (plan_blocks(rx).block_len, plan_blocks(rx).n_blocks))
        if plan0 is None:
            plan0 = p
        elif p != plan0:
            return _sequential("unmatched block plans across frontends")
        pairs.append((rx_name, tx, rx))
    return pairs
