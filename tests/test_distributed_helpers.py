"""Multi-host helper tests (single-process: all devices are local)."""

import numpy as np

from gpu_sdr.parallel import make_mesh
from gpu_sdr.parallel.distributed import host_local_block


def test_host_local_block_covers_everything():
    mesh = make_mesh((4, 2), ("time", "channels"))
    x = np.arange(8000, dtype=np.complex64)
    local, off = host_local_block(x, mesh)
    # single-process: this host owns all time shards
    assert off == 0
    assert np.array_equal(local, x)


def test_host_local_block_time_major():
    mesh = make_mesh((2, 4), ("time", "channels"))
    x = np.arange(1000, dtype=np.complex64)
    local, off = host_local_block(x, mesh)
    assert len(local) == 1000 and off == 0
