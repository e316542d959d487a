"""The measurement dispatch table, as code.

`run_measurement` is the framework's de-facto orchestrator (the
reference's TXRX::set role, cpp/USRP_server_link_threads.cpp:88-227): it
routes every (wave_type pair, mesh, periodicity, channel count,
recording) combination onto one of several execution paths — fused
loopback chains, device-resident replay, sharded SPMD chains, mixed
parallel demodulators, lock-step dual frontends, or the host-fed
pipeline.  Those decisions live in `measure._run_measurement_inner`,
`engine/fused.FusedLoopback` and `engine/replay.DeviceReplay`; this
module exposes them as a queryable PLAN so the routing is inspectable
without running anything.

``plan_dispatch(params, ...)`` returns one :class:`Decision` per active
RX antenna naming the top-level path, the chain sub-path, and the
deciding predicate.  Wherever the production builders gate on pure shape
math, the plan calls the SAME functions (plan_dual, can_fuse,
can_device_replay, ...);
tests/test_dispatch_table.py asserts the plan matches what
run_measurement actually built (`measure.LAST_DISPATCH`) across a
branch-covering battery, so the table cannot silently drift from the
code.  docs/07_dispatch.md renders the same table for humans.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..params import AntMode, UsrpParams, WaveType

# top-level paths
DUAL_FUSED = "dual_fused"
DUAL_SHARDED = "dual_sharded_fused"
FUSED_LOOPBACK = "fused_loopback"
SHARDED_FUSED = "sharded_fused"
SHARDED_REPLAY = "sharded_replay"
SHARDED_SEGMENTED = "sharded_segmented_replay"
DEVICE_REPLAY = "device_replay"
SEGMENTED_REPLAY = "segmented_replay"
HOST_PIPELINE = "host_pipeline"
HOST_MIXED = "host_pipeline_mixed"


@dataclasses.dataclass
class Decision:
    rx_name: str
    path: str                      # top-level execution path
    subpath: Optional[str] = None  # chain variant inside it
    reason: str = ""               # the deciding predicate, for humans

    def key(self):
        return (self.rx_name, self.path, self.subpath)


def _is_mixed(rx) -> bool:
    from ..measure import _is_mixed as m
    return m(rx)


def classify_loopback_chain(tx, rx):
    """Which chain FusedLoopback will run for this (tx, rx) pair.
    Mirrors FusedLoopback._try_tones_direct_chain using the same shape
    math (ops/fold_chain.TonesDirectFoldChain.ok)."""
    from .planner import plan_blocks
    L = plan_blocks(rx).block_len
    w_tx = tx.wave_type[0] if tx.wave_type else None
    w_rx = rx.wave_type[0] if rx.wave_type else None

    if w_tx == WaveType.TONES and w_rx == WaveType.DIRECT:
        if tx.burst_on > 0 or int(rx.decim) <= 0 or int(rx.pf_average) < 2:
            return "generic_scan", "burst/decim/pf_average gate"
        if not tx.freq or not rx.freq:
            return "generic_scan", "no tones"
        if L % int(rx.decim) == 0:
            return "fold_chain", "shift-fold algebra, one matmul per block"
        return "generic_scan", "fold chain infeasible"

    return "generic_scan", "no fused chain for this mode pair"


def classify_sharded_fused(tx, rx, mesh):
    """Which chain make_sharded_fused builds (the plan==actual battery
    pins it, tests/test_dispatch_table.py)."""
    w = rx.wave_type[0]
    if w == WaveType.CHIRP:
        return "chirp_lockin", "per-shard chirp synth + lock-in, no halo"
    if w == WaveType.DIRECT:
        return "fold_chain", "shift-fold chain per shard, zero collectives"
    return "pfb_scan", "presum + DFT + psum-select SPMD chain"


def plan_dispatch(params: UsrpParams, source=None, channel=None,
                  mesh=None) -> List[Decision]:
    """Predict run_measurement's routing without executing anything
    heavyweight.  Same decision order as measure._run_measurement_inner.
    """
    from ..measure import _is_mixed, _pair_tx
    from .replay import can_device_replay, can_segmented_replay
    decisions: List[Decision] = []

    if source is None and channel is None:
        from .dual import plan_dual
        pairs = plan_dual(params, mesh=mesh)
        if pairs is not None:
            path = DUAL_FUSED if mesh is None else DUAL_SHARDED
            for rx_name, tx, rx in pairs:
                sub = (classify_loopback_chain(tx, rx)[0]
                       if mesh is None else None)
                decisions.append(Decision(
                    rx_name, path, sub,
                    ">=2 fusable frontends, common block plan"))
            return decisions

    for rx_name, rx in params.active_antennas(AntMode.RX):
        mixed = _is_mixed(rx)
        tx_name = _pair_tx(params, rx_name)
        tx = params.antenna(tx_name) if tx_name else None

        if source is None and channel is None and not mixed:
            if mesh is None:
                from .fused import can_fuse
                if tx is not None and can_fuse(tx, rx) and \
                        rx.delay <= tx.delay:
                    sub, why = classify_loopback_chain(tx, rx)
                    decisions.append(
                        Decision(rx_name, FUSED_LOOPBACK, sub, why))
                    continue
            else:
                from ..parallel.fused_sharded import can_fuse_sharded
                if tx is not None and can_fuse_sharded(tx, rx, mesh) and \
                        rx.delay <= tx.delay:
                    sub, why = classify_sharded_fused(tx, rx, mesh)
                    decisions.append(Decision(
                        rx_name, SHARDED_FUSED, sub, why))
                    continue

        if source is not None and channel is None and not mixed:
            if mesh is not None and can_device_replay(source):
                from .demodulator import make_demodulator as _mk
                loop = bool(getattr(source, "loop", False))
                blk = _mk(rx, mesh=mesh).plan.block_len
                if not (loop and len(source.data) % blk != 0):
                    decisions.append(Decision(
                        rx_name, SHARDED_REPLAY, "scan",
                        "recording fits the device budget, mesh given"))
                    continue
            if mesh is not None and can_segmented_replay(source):
                from .demodulator import make_demodulator as _mk
                loop = bool(getattr(source, "loop", False))
                blk = _mk(rx, mesh=mesh).plan.block_len
                if not (loop and len(source.data) % blk != 0):
                    decisions.append(Decision(
                        rx_name, SHARDED_SEGMENTED, None,
                        "recording exceeds the device budget, mesh given: "
                        "sharded segment refill"))
                    continue
            if mesh is None and can_device_replay(source):
                from .planner import plan_blocks
                loop = bool(getattr(source, "loop", False))
                blk = plan_blocks(rx).block_len
                if not (loop and len(source.data) % blk != 0):
                    decisions.append(Decision(
                        rx_name, DEVICE_REPLAY, "scan",
                        "recording fits the device budget"))
                    continue
            if mesh is None and can_segmented_replay(source):
                from .planner import plan_blocks
                loop = bool(getattr(source, "loop", False))
                blk = plan_blocks(rx).block_len
                if not (loop and len(source.data) % blk != 0):
                    decisions.append(Decision(
                        rx_name, SEGMENTED_REPLAY, None,
                        "recording exceeds the device budget: double-buffered "
                        "segment refill"))
                    continue

        decisions.append(Decision(
            rx_name, HOST_MIXED if mixed else HOST_PIPELINE,
            None, "mixed wave types on one antenna" if mixed
            else "no fused/replay path applies"))
    return decisions
