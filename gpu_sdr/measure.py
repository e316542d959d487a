"""In-process measurement execution.

The functional core of a measurement: given a validated
:class:`~gpu_sdr.params.UsrpParams`, build TX generators and RX
demodulators, route TX->channel->RX (the reference's --sw_loop path, or a
physical channel model / replay file), and stream into an HDF5 file with the
reference layout.

This is the in-process equivalent of the reference's full round trip
(client Async_send -> server main loop -> TXRX set/start -> demod -> TCP ->
client Packets_to_file); the TCP server in gpu_sdr.server exposes the
same execution over the wire protocol for remote clients.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .engine import make_demodulator, make_generator, run_pipeline
from .engine.channel import Channel, IdealChannel
from .engine.sinks import Sink
from .engine.sources import Source, WhiteNoiseSource
from .params import AntMode, UsrpParams


# the execution paths the last run_measurement call actually took, one
# (rx_name, path, subpath) per RX antenna — mirrors the predictions of
# engine/dispatch.plan_dispatch (tests/test_dispatch_table.py asserts
# they agree; docs/07_dispatch.md is the human-readable table).
# Module-level state is safe under the one-process-owns-the-chip model
# (CLAUDE.md); concurrent run_measurement calls would interleave records,
# so consumers should snapshot via last_dispatch() right after the call.
LAST_DISPATCH: list = []


def last_dispatch() -> tuple:
    """Immutable snapshot of the execution paths the most recent
    run_measurement call took (one (rx_name, path, subpath) per RX)."""
    return tuple(LAST_DISPATCH)


def _record_dispatch(rx_name: str, path: str, subpath=None) -> None:
    LAST_DISPATCH.append((rx_name, path, subpath))
    from .utils.log import get_logger
    get_logger("dispatch").info(
        "dispatch %s -> %s%s", rx_name, path,
        f":{subpath}" if subpath else "")


class ChannelSource(Source):
    """TX generator -> channel model -> RX blocks.

    `skip_samples` emulates the reference's timed RX start: the RX stream
    begins `delay` seconds after TX (the `delay` parameter applied to the
    UHD stream command, cpp/USRP_hardware_manager.cpp:1178-1291), which is
    how line-delay compensation re-aligns the chirp lock-in.
    """

    def __init__(self, generator, channel: Channel, skip_samples: int = 0):
        self.generator = generator
        self.channel = channel
        self.skip = int(skip_samples)

    def take_errors(self) -> int:
        """Error events injected by the channel since the last call (rides
        the RX_wrapper.errors field like the reference's UHD error
        counters)."""
        fn = getattr(self.channel, "take_errors", None)
        return int(fn()) if fn else 0

    def blocks(self, block_len: int, n_blocks: int):
        assert block_len == self.generator.block_len
        buf = np.zeros(0, dtype=np.complex64)
        to_skip = self.skip
        extra = -(-self.skip // block_len)  # ceil: extra TX blocks needed
        emitted = 0
        for x in self.generator.blocks(n_blocks + extra):
            y = np.asarray(self.channel(x), dtype=np.complex64)
            if to_skip:
                drop = min(to_skip, len(y))
                y = y[drop:]
                to_skip -= drop
            buf = np.concatenate([buf, y]) if len(buf) else y
            while len(buf) >= block_len and emitted < n_blocks:
                yield buf[:block_len]
                buf = buf[block_len:]
                emitted += 1
            if emitted >= n_blocks:
                return
        while emitted < n_blocks:           # generator ran dry: zero-pad
            pad = np.zeros(block_len, dtype=np.complex64)
            pad[:len(buf)] = buf
            yield pad
            buf = np.zeros(0, dtype=np.complex64)
            emitted += 1


def _is_mixed(rx) -> bool:
    """Antenna with more than one wave type (parallel demodulators; the
    reference rejects this, cpp/USRP_demodulator.cpp:36-39)."""
    return bool(rx.wave_type) and any(w != rx.wave_type[0]
                                      for w in rx.wave_type)


def _pair_tx(params: UsrpParams, rx_name: str) -> Optional[str]:
    """Find the TX antenna driving a given RX (same front end letter,
    mirroring the reference's A_TXRX->A_RX2 pairing)."""
    letter = rx_name[0]
    for name, p in params.active_antennas(AntMode.TX):
        if name.startswith(letter):
            return name
    for name, p in params.active_antennas(AntMode.TX):
        return name
    return None


def run_measurement(params: UsrpParams, filename: Optional[str] = None,
                    channel: Optional[Channel] = None,
                    source: Optional[Source] = None,
                    extra_sinks: Sequence[Sink] = (),
                    trigger=None, mesh=None, **tags) -> Optional[str]:
    """Execute a measurement described by `params`.

    * If `source` is given, it replaces the radio (replay mode).
    * Else if a TX antenna is active, TX drives RX through `channel`
      (default ideal loopback).
    * Else RX consumes white noise.

    Writes an HDF5 file in the reference layout when `filename` is given and
    returns the filename; with filename=None only `extra_sinks` receive data.
    """
    from .client.files import H5Sink
    from .config import configure_precision, maybe_profile

    configure_precision()
    params.validate()
    _profile_cm = maybe_profile("measurement")
    _profile_cm.__enter__()
    try:
        return _run_measurement_inner(params, filename, channel, source,
                                      extra_sinks, trigger, mesh, tags,
                                      H5Sink)
    finally:
        _profile_cm.__exit__(None, None, None)


def _run_measurement_inner(params, filename, channel, source, extra_sinks,
                           trigger, mesh, tags, H5Sink):
    results = []
    out_name = None
    LAST_DISPATCH.clear()
    # Concurrent A/B frontends: >=2 fusable RX chains advance in
    # lock-step inside ONE jitted program on a shared sample timebase
    # (the reference's synchronized per-frontend thread chains,
    # cpp/USRP_server_link_threads.cpp:249-397)
    if source is None and channel is None:
        from .engine.dual import DualFused, DualShardedFused, plan_dual
        pairs = plan_dual(params, mesh=mesh)
        dual = None
        if pairs is not None:
            dual = (DualFused(pairs) if mesh is None
                    else DualShardedFused(pairs, mesh))
            if not getattr(dual, "ok", True):
                dual = None       # untileable -> sequential fallback
        if dual is not None:
            for i, (rx_name, _tx, _rx) in enumerate(pairs):
                chains = getattr(dual, "chains", None)
                _record_dispatch(
                    rx_name,
                    "dual_fused" if mesh is None else "dual_sharded_fused",
                    getattr(chains[i], "path", None) if chains else None)
            sinks_per_fe = []
            for rx_name, _tx, _rx in pairs:
                sinks = list(extra_sinks)
                if filename is not None:
                    h5 = H5Sink(filename, params, ant_name=rx_name,
                                trigger=trigger, **tags)
                    sinks.append(h5)
                    out_name = h5.filename
                sinks_per_fe.append(sinks)
            results = dual.run(sinks_per_fe,
                               usrp_number=params.usrp_number)
            return out_name if filename is not None else None
    for rx_name, rx in params.active_antennas(AntMode.RX):
        # Fast path: ideal loopback with no channel model fuses the whole
        # TX->demod chain on-device, scan-chained (engine/fused.py)
        if source is None and channel is None and mesh is None and \
                not _is_mixed(rx):
            from .engine.fused import FusedLoopback, can_fuse
            tx_name = _pair_tx(params, rx_name)
            tx = params.antenna(tx_name) if tx_name else None
            if tx is not None and can_fuse(tx, rx) and \
                    rx.delay <= tx.delay:
                sinks = list(extra_sinks)
                if filename is not None:
                    h5 = H5Sink(filename, params, ant_name=rx_name,
                                trigger=trigger, **tags)
                    sinks.append(h5)
                    out_name = h5.filename
                fused = FusedLoopback(tx, rx)
                _record_dispatch(rx_name, "fused_loopback", fused.path)
                res = fused.run(sinks, usrp_number=params.usrp_number,
                                front_end=rx_name[0])
                results.append(res)
                continue
        # Sharded fast path: the same fused chain as ONE SPMD program over
        # the mesh (parallel/fused_sharded.py)
        if source is None and channel is None and mesh is not None and \
                not _is_mixed(rx):
            from .parallel.fused_sharded import (
                can_fuse_sharded, make_sharded_fused, plan_sharded_block)
            tx_name = _pair_tx(params, rx_name)
            tx = params.antenna(tx_name) if tx_name else None
            if tx is not None and can_fuse_sharded(tx, rx, mesh) and \
                    rx.delay <= tx.delay:
                L, nb = plan_sharded_block(rx, mesh)
                sf = make_sharded_fused(tx, rx, mesh,
                                        blocks_per_exec=min(8, nb),
                                        block_len=L)
                if sf is not None:     # None: untileable -> non-fused path
                    sinks = list(extra_sinks)
                    if filename is not None:
                        h5 = H5Sink(filename, params, ant_name=rx_name,
                                    trigger=trigger, **tags)
                        sinks.append(h5)
                        out_name = h5.filename
                    _record_dispatch(rx_name, "sharded_fused",
                                     getattr(sf, "path", None))
                    res = sf.run(sinks, usrp_number=params.usrp_number,
                                 front_end=rx_name[0], n_blocks=nb)
                    results.append(res)
                    continue
        # Mesh-dispatched replay: the recording is uploaded once, time-
        # sharded over the mesh, and scanned through the SHARDED
        # demodulator (parallel/sharded_replay.py)
        if source is not None and channel is None and mesh is not None \
                and not _is_mixed(rx):
            from .engine.replay import can_device_replay
            from .parallel.sharded_replay import ShardedDeviceReplay
            if can_device_replay(source):
                from .engine.demodulator import make_demodulator as _mk
                loop = bool(getattr(source, "loop", False))
                blk = _mk(rx, mesh=mesh).plan.block_len
                if not (loop and len(source.data) % blk != 0):
                    sr = ShardedDeviceReplay(rx, np.asarray(source.data),
                                             mesh, loop=loop)
                    sinks = list(extra_sinks)
                    if filename is not None:
                        h5 = H5Sink(filename, params, ant_name=rx_name,
                                    trigger=trigger, **tags)
                        sinks.append(h5)
                        out_name = h5.filename
                    _record_dispatch(rx_name, "sharded_replay", sr.path)
                    res = sr.run(sinks, usrp_number=params.usrp_number,
                                 front_end=rx_name[0])
                    results.append(res)
                    continue
        # Mesh + oversized recording: chunked HBM-refill through the
        # SHARDED demodulator (segments staged with sharded device_put)
        if source is not None and channel is None and mesh is not None \
                and not _is_mixed(rx):
            from .engine.replay import can_segmented_replay
            from .parallel.sharded_replay import ShardedSegmentedReplay
            if can_segmented_replay(source):
                from .engine.demodulator import make_demodulator as _mk
                loop = bool(getattr(source, "loop", False))
                blk = _mk(rx, mesh=mesh).plan.block_len
                if not (loop and len(source.data) % blk != 0):
                    sr = ShardedSegmentedReplay(rx, source.data, mesh,
                                                loop=loop)
                    _record_dispatch(rx_name, "sharded_segmented_replay")
                    sinks = list(extra_sinks)
                    if filename is not None:
                        h5 = H5Sink(filename, params, ant_name=rx_name,
                                    trigger=trigger, **tags)
                        sinks.append(h5)
                        out_name = h5.filename
                    res = sr.run(sinks, usrp_number=params.usrp_number,
                                 front_end=rx_name[0])
                    results.append(res)
                    continue
        # Device-resident replay: a recording that fits HBM is uploaded
        # once and demodulated scan-chained (engine/replay.py) instead of
        # feeding every block over the host link
        if source is not None and channel is None and mesh is None and \
                not _is_mixed(rx):
            from .engine.replay import DeviceReplay, can_device_replay
            if can_device_replay(source):
                from .engine.planner import plan_blocks
                loop = bool(getattr(source, "loop", False))
                blk = plan_blocks(rx).block_len
                if not (loop and len(source.data) % blk != 0):
                    dr = DeviceReplay(rx, np.asarray(source.data),
                                      loop=loop)
                    _record_dispatch(rx_name, "device_replay", dr.path)
                    sinks = list(extra_sinks)
                    if filename is not None:
                        h5 = H5Sink(filename, params, ant_name=rx_name,
                                    trigger=trigger, **tags)
                        sinks.append(h5)
                        out_name = h5.filename
                    res = dr.run(sinks, usrp_number=params.usrp_number,
                                 front_end=rx_name[0])
                    results.append(res)
                    continue
        # Chunked HBM-refill replay: a recording too large for one upload
        # is cut into double-buffered segments so it keeps the
        # device-resident path instead of dropping to per-block host feed
        if source is not None and channel is None and mesh is None and \
                not _is_mixed(rx):
            from .engine.replay import (SegmentedDeviceReplay,
                                        can_segmented_replay)
            if can_segmented_replay(source):
                from .engine.planner import plan_blocks
                loop = bool(getattr(source, "loop", False))
                blk = plan_blocks(rx).block_len
                if not (loop and len(source.data) % blk != 0):
                    sr = SegmentedDeviceReplay(rx, source.data, loop=loop)
                    _record_dispatch(rx_name, "segmented_replay")
                    sinks = list(extra_sinks)
                    if filename is not None:
                        h5 = H5Sink(filename, params, ant_name=rx_name,
                                    trigger=trigger, **tags)
                        sinks.append(h5)
                        out_name = h5.filename
                    res = sr.run(sinks, usrp_number=params.usrp_number,
                                 front_end=rx_name[0])
                    results.append(res)
                    continue
        demod = make_demodulator(rx, mesh=mesh)
        if source is not None:
            src = source
        else:
            tx_name = _pair_tx(params, rx_name)
            if tx_name is not None:
                tx = params.antenna(tx_name)
                gen = make_generator(tx, block_len=demod.plan.block_len)
                # timed RX start: honor the delay parameter difference
                # (line-delay compensation, reference
                # cpp/USRP_hardware_manager.cpp stream-command time_spec)
                skip = int(round(max(rx.delay - tx.delay, 0.0) * rx.rate))
                src = ChannelSource(gen, channel or IdealChannel(),
                                    skip_samples=skip)
            else:
                src = WhiteNoiseSource()
        _record_dispatch(rx_name, "host_pipeline_mixed" if _is_mixed(rx)
                         else "host_pipeline")
        if _is_mixed(rx):
            # parallel per-type demodulators over the same stream; group
            # 0 fills `data`, group k>0 a `mixed_<k>` dataset
            from .engine.pipeline import run_pipeline_mixed
            sinks_per_group = []
            for k, g in enumerate(demod.groups):
                sinks = list(extra_sinks) if k == 0 else []
                if filename is not None:
                    h5 = H5Sink(filename, params, ant_name=rx_name,
                                trigger=trigger if k == 0 else None,
                                dataset="data" if k == 0 else f"mixed_{k}",
                                sub_params=g.params,
                                channel_index=g.channel_idx, **tags)
                    sinks.append(h5)
                    out_name = h5.filename
                sinks_per_group.append(sinks)
            res = run_pipeline_mixed(demod, src, sinks_per_group,
                                     usrp_number=params.usrp_number,
                                     front_end=rx_name[0])
            results.append(res)
            if filename is not None and getattr(src, "aborted", False):
                _flag_aborted(out_name, params.usrp_number, rx_name, src)
            continue
        sinks = list(extra_sinks)
        if filename is not None:
            h5 = H5Sink(filename, params, ant_name=rx_name, trigger=trigger,
                        **tags)
            sinks.append(h5)
            out_name = h5.filename
        res = run_pipeline(demod, src, sinks,
                           usrp_number=params.usrp_number,
                           front_end=rx_name[0])
        results.append(res)
        if filename is not None and getattr(src, "aborted", False):
            _flag_aborted(out_name, params.usrp_number, rx_name, src)
    return out_name if filename is not None else None


def _flag_aborted(filename, usrp_number, rx_name, src) -> None:
    """Stamp an aborted (under-delivered) acquisition on its H5 group so
    analysis can tell a short file from a complete one — the reference
    declares "USRP is not streaming" and aborts instead of fabricating
    samples (cpp/USRP_hardware_manager.cpp:1546-1560)."""
    import h5py
    with h5py.File(filename, "a") as f:
        g = f[f"raw_data{int(usrp_number)}"][rx_name]
        g.attrs["aborted"] = True
        g.attrs["shortfall_blocks"] = int(
            getattr(src, "shortfall_blocks", 0))
