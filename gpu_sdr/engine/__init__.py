"""Streaming engine: the replacement for the reference's
thread/queue pipeline (TXRX, cpp/USRP_server_link_threads.cpp).

Instead of UHD-RX -> lock-free queues -> GPU worker threads -> TCP/H5 sinks,
the engine is a host loop over fixed-size IQ blocks driving jitted step
functions whose carried state (phase accumulators, FIR tails, PFB spares) is
an explicit pytree:

    state, out = step(state, block)        # jit-compiled once

Sources replay recorded IQ or synthesize it on-device (the reference's
--sw_loop software loopback, cpp/USRP_hardware_manager.cpp:1071-1395); sinks
write HDF5 (reference H5_file_writer) and/or stream the wire format
(reference Sync_server).
"""

from .planner import BlockPlan, plan_blocks  # noqa: F401
from .demodulator import make_demodulator, Demodulator  # noqa: F401
from .generator import make_generator, Generator  # noqa: F401
from .pipeline import run_pipeline, PipelineResult  # noqa: F401
from .checkpoint import save_state, load_state  # noqa: F401
from .fused import FusedLoopback, can_fuse  # noqa: F401
from .ingest import HostFeed, SocketIngestSource  # noqa: F401
