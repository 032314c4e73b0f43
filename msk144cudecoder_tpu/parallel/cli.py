"""Distributed decode runner: `python -m msk144cudecoder_tpu.parallel`.

The single-process CLI drives one device; this runner scales a capture
across every device of every process in a jax.distributed job — the
deployment story the reference cannot offer (it is single-process
single-GPU, SURVEY §2). Every process runs the SAME command on the same
capture file:

  # process 0 and process 1 (two hosts, or two cards of one host):
  python -m msk144cudecoder_tpu.parallel --input capture.raw \
      --coordinator host0:1234 --num-processes 2 --process-id 0 &
  python -m msk144cudecoder_tpu.parallel --input capture.raw \
      --coordinator host0:1234 --num-processes 2 --process-id 1

How the work is laid out (parallel/multihost.py):

  * the global (time, freq) mesh spans all processes' devices — time rows
    across processes (each host decodes its own stream segment), frequency
    shards within a host (the reference's CUDA grid axis, one top-K
    survivor list per shard, gathered on output);
  * each process reads ONLY its own byte range of the input (window range +
    one-window overlap halo at the segment tail, host_sample_range), so
    ingest I/O never crosses hosts;
  * decode steps run in lockstep (same file length everywhere -> same step
    count; the tail batch zero-pads), and each process prints only its own
    windows' decode lines — concatenating the per-process stdouts in
    process order reproduces the single-stream output order.

With one process this is still useful: it frequency-shards a capture over
all local cards (`--mesh-time 1`).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from .. import constants as C
from ..config import DecoderConfig


def build_parser() -> argparse.ArgumentParser:
    from ..cli import build_parser as base_parser

    p = base_parser()
    p.prog = "msk144tpudecoder-parallel"
    p.description = ("Distributed MSK144 decode of a capture file over a "
                     "jax.distributed (time, freq) device mesh. Run the "
                     "same command on every process.")
    p.add_argument("--input", required=True,
                   help="capture file (16-bit mono audio or 2x8-bit IQ, "
                        "per --read-mode); every process reads its own "
                        "segment of the same file")
    p.add_argument("--coordinator", default=None,
                   help="coordinator host:port (or MSK144_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mesh-time", type=int, default=None,
                   help="time-axis size (default: number of processes)")
    p.add_argument("--mesh-freq", type=int, default=None,
                   help="freq-axis size (default: devices / mesh-time)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    import os

    import jax

    from ..cli import config_from_args, print_banner
    from ..runtime import StreamDecoder
    from ..runtime.backend import (DEFAULT_PLATFORM, NoDeviceError,
                                   enable_persistent_cache, use_platform)
    from . import multihost
    from .sharding import MeshDecoder

    cfg = config_from_args(args)
    if (args.coordinator or args.num_processes is not None
            or os.environ.get("MSK144_COORDINATOR")
            or os.environ.get("MSK144_NUM_PROCESSES")):
        # multi-process opt-in: jax.distributed must start before any
        # backend, so the platform is fixed first and checked after
        jax.config.update("jax_platforms", args.platform or DEFAULT_PLATFORM)
        multihost.init_distributed(args.coordinator, args.num_processes,
                                   args.process_id)
    try:
        use_platform(args.platform)
    except NoDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    enable_persistent_cache()
    mesh = multihost.global_mesh(args.mesh_time, args.mesh_freq)
    pid, nproc = jax.process_index(), jax.process_count()
    n_time = mesh.shape["time"]
    n_freq = mesh.shape["freq"]
    if pid == 0:
        print_banner(cfg)
        print(f"Mesh: {n_time} (time) x {n_freq} (freq) over {nproc} "
              f"process(es), {len(jax.devices())} device(s): "
              f"{[d.id for d in mesh.devices.flat]}", file=sys.stderr)

    if n_time % nproc:
        print(f"mesh time axis ({n_time}) must be a multiple of the "
              f"process count ({nproc})", file=sys.stderr)
        return 1

    per = 2 if cfg.read_mode == 2 else 1
    itemsize = 1 if cfg.read_mode == 2 else 2
    dtype = np.int8 if cfg.read_mode == 2 else np.int16

    total_samples = os.path.getsize(args.input) // itemsize
    total_windows = (total_samples - C.WINDOW_LEN * per) // (C.HOP_LEN * per) + 1
    if total_windows < 1:
        if pid == 0:
            print("Input shorter than one window", file=sys.stderr)
        return 1

    # Each TIME ROW of the mesh owns a contiguous window range of the
    # capture; a process owns n_time/nproc consecutive rows and reads only
    # those rows' sample segments (window range + one-window halo). One
    # StreamDecoder per owned row keeps the SNR EMA and dedup scope local
    # to that row's contiguous stream segment.
    tpp = n_time // nproc  # time rows per process
    my_rows = list(range(pid * tpp, (pid + 1) * tpp))
    segs, decs, n_locals = [], [], []
    md = MeshDecoder(cfg, mesh)
    with open(args.input, "rb") as f:
        for t in my_rows:
            wlo, whi = multihost.host_window_range(total_windows, n_time, t)
            slo, shi = multihost.host_sample_range(total_windows, n_time, t,
                                                   cfg.read_mode)
            f.seek(slo * itemsize)
            segs.append(np.frombuffer(f.read((shi - slo) * itemsize), dtype))
            decs.append(StreamDecoder(
                cfg, survivor_capacity=cfg.max_survivors * n_freq,
                freqs=md.freqs))
            n_locals.append(whi - wlo)

    # lockstep steps: every time row contributes `wb` of its own windows
    # per step (global batch = wb * n_time rows, block-partitioned over the
    # time axis in row order); short rows zero-pad
    wb = max(1, cfg.window_batch)
    per_row_max = -(-total_windows // n_time)  # longest row's window count
    n_steps = -(-per_row_max // wb)
    raw_len = C.WINDOW_LEN * per
    import time

    from jax.experimental import multihost_utils

    t_steady = None  # wall clock after the first step (compile excluded)
    for step in range(n_steps):
        rows = []
        valids = []
        for seg, n_local in zip(segs, n_locals):
            valid = 0
            for i in range(step * wb, (step + 1) * wb):
                if i < n_local:
                    o = i * C.HOP_LEN * per
                    rows.append(seg[o:o + raw_len])
                    valid += 1
                else:
                    rows.append(np.zeros(raw_len, dtype))
            valids.append(valid)
        res = md.decode(multihost.global_windows(np.stack(rows), mesh))
        # results are time-sharded on the batch axis, so a process's own
        # time rows are its locally ADDRESSABLE shards: materialize only
        # those (zero cross-host result traffic). process_allgather remains
        # only as a per-leaf fallback for non-addressable layouts.
        glo = my_rows[0] * wb
        ghi = (my_rows[-1] + 1) * wb
        host_rows = []
        for x in res:
            local = multihost.addressable_rows(x, glo, ghi)
            if local is None:
                local = np.asarray(multihost_utils.process_allgather(
                    x, tiled=True))[glo:ghi]
            host_rows.append(local)
        host_res = type(res)(*host_rows)
        for r, (dec, valid) in enumerate(zip(decs, valids)):
            lo = r * wb  # row-local offset into this process's rows
            batch_view = type(res)(*(x[lo:lo + wb] for x in host_res))
            for items in dec.postprocess_batch(batch_view, valid):
                for item in items:
                    print(item.format_line(), flush=True)
        if t_steady is None:
            t_steady = time.perf_counter()
    if pid == 0 and n_steps > 1:
        # windows decoded after the first (compiling) step, all processes
        wall = time.perf_counter() - t_steady
        n_win = 0
        for t in range(n_time):
            lo, hi = multihost.host_window_range(total_windows, n_time, t)
            n_win += max(0, hi - lo - wb)
        print(f"Throughput: {n_win} windows in {wall:.2f} s = "
              f"{wall / n_win * 1e3:.3f} ms/window (steady-state after "
              f"first step)", file=sys.stderr)
    if pid == 0:
        print("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
