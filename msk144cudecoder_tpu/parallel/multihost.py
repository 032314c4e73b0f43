"""Multi-process decode: jax.distributed + process-local streams.

The reference is strictly single-process (SURVEY §2: no NCCL/MPI/anything).
The scale-out path works like this:

  * every process calls `init_distributed()` with a coordinator address and
    process count (args or MSK144_* env vars) — one process per host, or
    one per card on a host
  * the global mesh spans all processes' devices: `(time, freq)` as in
    sharding.py — freq shards within a process, time shards on different
    processes so each ingests its own stream segment from local I/O
  * each process frames its local windows (50% overlap handled locally — a
    window never straddles processes because they own disjoint half-open
    [start, start + n_windows * HOP) ranges with a one-window halo read
    from their segment tail, mirroring the single-stream slide)
  * `global_windows()` assembles the global (B, L) array from process-local
    batches with jax.make_array_from_process_local_data
  * each process materializes only its own time rows of the result
    (addressable_rows) and prints only its own windows' messages

Tested with multi-process CPU (two python processes, see
tests/test_multihost.py). On four GPUs with one process per card the
compile of the (4, 1)-mesh program has crashed one process (PERF.md).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed from args or MSK144_* env vars."""
    kwargs = {}
    coord = coordinator_address or os.environ.get("MSK144_COORDINATOR")
    if coord:
        kwargs["coordinator_address"] = coord
    np_ = num_processes if num_processes is not None else os.environ.get("MSK144_NUM_PROCESSES")
    if np_ is not None:
        kwargs["num_processes"] = int(np_)
    pid = process_id if process_id is not None else os.environ.get("MSK144_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def global_mesh(n_time: Optional[int] = None, n_freq: Optional[int] = None) -> Mesh:
    """(time, freq) mesh over all processes' devices. Default: time = number
    of processes (each owns its stream segment), freq = devices/process."""
    devs = np.asarray(jax.devices())
    n_proc = jax.process_count()
    if n_time is None:
        n_time = n_proc
    if n_freq is None:
        n_freq = len(devs) // n_time
    if n_time * n_freq != len(devs):
        raise ValueError(f"mesh {n_time}x{n_freq} != {len(devs)} devices")
    # order devices so the time axis varies across processes
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs).reshape(n_time, n_freq), axis_names=("time", "freq"))


def host_window_range(total_windows: int, n_hosts: int, host: int) -> tuple[int, int]:
    """Contiguous [lo, hi) window indices owned by `host` (balanced split)."""
    per = -(-total_windows // n_hosts)
    lo = min(host * per, total_windows)
    return lo, min(lo + per, total_windows)


def host_sample_range(total_windows: int, n_hosts: int, host: int,
                      read_mode: int = 1) -> tuple[int, int]:
    """Sample [lo, hi) of the stream this host must ingest to frame its
    windows, including the half-window overlap halo at the segment tail."""
    per = 2 if read_mode == 2 else 1
    wlo, whi = host_window_range(total_windows, n_hosts, host)
    lo = wlo * C.HOP_LEN * per
    hi = (whi - 1) * C.HOP_LEN * per + C.WINDOW_LEN * per if whi > wlo else lo
    return lo, hi


def global_windows(local_windows: np.ndarray, mesh: Mesh) -> jax.Array:
    """Assemble the global (B, L) batch from each process's local windows,
    sharded (time, None). Every process passes only its own windows."""
    sharding = NamedSharding(mesh, P("time", None))
    return jax.make_array_from_process_local_data(sharding, local_windows)


def addressable_rows(x, lo: int, hi: int) -> Optional[np.ndarray]:
    """Global batch rows [lo, hi) of a batch-leading array, assembled from
    THIS process's addressable shards only — no cross-host traffic.

    The decode result is time-sharded on its leading axis (sharding.py
    out_specs), and a host's own time rows — the only rows it
    post-processes — are by construction its locally addressable shards
    (its devices span all freq columns of its time rows, global_mesh).
    Gathering the whole global batch to every process just to slice out
    local rows (the round-4 runner) cost O(n_hosts) redundant cross-host traffic
    per step in the one code path that exists to scale hosts.

    Returns None when the addressable shards do not cover [lo, hi) (a leaf
    sharded some other way) — the caller falls back to a collective gather
    for that leaf.
    """
    if not hasattr(x, "addressable_shards"):
        return np.asarray(x)[lo:hi]
    shape = (hi - lo,) + x.shape[1:]
    out = np.empty(shape, dtype=x.dtype)
    cov = np.zeros(shape[:2] if x.ndim >= 2 else shape[:1], dtype=bool)
    for sh in x.addressable_shards:
        idx = tuple(sh.index)
        # coverage is tracked over the first two axes only; a shard that
        # slices any LATER axis would be double-counted by that tracking,
        # so such layouts take the collective fallback (none of the
        # bundled out_specs shard past axis 1)
        for j in range(2, len(idx)):
            s = idx[j]
            if (s.start or 0) != 0 or (s.stop is not None
                                       and s.stop != x.shape[j]):
                return None
        r = idx[0] if idx else slice(None)
        rs = r.start or 0
        re_ = r.stop if r.stop is not None else x.shape[0]
        a, b = max(rs, lo), min(re_, hi)
        if a >= b:
            continue
        data = np.asarray(sh.data)
        sel_out = (slice(a - lo, b - lo),) + idx[1:]
        out[sel_out] = data[a - rs : b - rs]
        cov[sel_out[: cov.ndim]] = True
    return out if bool(cov.all()) else None
