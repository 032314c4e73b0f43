"""Command-line interface: stdin samples in, decoded message lines out.

Flag surface, defaults, banner, and output line format mirror the reference
(/root/reference/src/main.cu:58-68,122-208,233-252,406-419). The help/code
default mismatches in the reference (scan-depth 3 vs 4, nbadsync 2 vs 1) are
resolved in favor of the code defaults; the help text states the real values.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import constants as C
from .config import DecoderConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="msk144tpudecoder",
        description=(
            "MSK144 stream decoder on JAX. Reads 12 kS/s samples on stdin "
            "(16-bit signed mono audio, or 2x8-bit signed IQ), prints decoded "
            "messages on stdout."
        ),
    )
    p.add_argument("--center-frequency", type=float, default=None,
                   help="center frequency in Hz (default: 1500 audio, 0 IQ)")
    p.add_argument("--search-step", type=float, default=2.0,
                   help="frequency search step in Hz (default 2.0)")
    p.add_argument("--search-width", type=float, default=200.0,
                   help="frequency search width in Hz (default 200)")
    p.add_argument("--scan-depth", type=int, default=4,
                   help="frame-averaging depth 1..8 (default 4)")
    p.add_argument("--read-mode", type=int, default=1, choices=(1, 2),
                   help="1 = 16-bit audio, 2 = 2x8-bit IQ (default 1)")
    p.add_argument("--analytic-method", type=int, default=2, choices=(1, 2),
                   help="1 = FFT Hilbert, 2 = shift+FIR+shift (default 2)")
    p.add_argument("--nbadsync-threshold", type=int, default=1,
                   help="max bad sync bits per candidate (default 1)")
    p.add_argument("--max-survivors", type=int, default=256,
                   help="static LDPC batch size (top-K survivors under "
                        "per-pattern quotas; 256 reproduces the "
                        "decode-everything reference behavior on the busy-"
                        "band battery — see config.py). Heavy-pileup bands "
                        "may want 512: the battery's regime is 4 "
                        "simultaneous pings, and the survivor-overflow "
                        "warning on stderr is the signal to raise this")
    p.add_argument("--scan-decimation", type=int, default=4, choices=(1, 2, 4),
                   help="coarse sync-scan lag grid: select candidates on "
                        "every Nth lag (the demod absorbs the <=N-1-sample "
                        "candidate offset). 1 = the full per-lag grid, "
                        "exact reference scan semantics (default 4)")
    p.add_argument("--candidates-per-pattern", type=int, default=8,
                   help="top-k candidate lags demodulated per (frequency, "
                        "pattern), 1..8 (default 8 = reference behavior; "
                        "lower k cuts demod work proportionally, keeping the "
                        "best-sync lags)")
    p.add_argument("--survivor-prefilter", type=int, default=None,
                   help="demodulate only the top-P candidates by scan sync "
                        "correlation (default: auto = 2x max-survivors; "
                        "0 = off, demodulate every candidate like the "
                        "reference)")
    p.add_argument("--window-batch", type=int, default=1,
                   help="windows decoded per device call")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="batches in flight in throughput mode (window-batch "
                        "> 1): device calls for up to this many batches run "
                        "concurrently while post-processing stays in stream "
                        "order; 1 = fully synchronous (default 4)")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform to decode on (default cuda; the "
                        "decoder stops when it finds no such device). "
                        "cpu runs on the host CPU")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a jax.profiler trace to this directory (the "
                        "analog of the reference's USE_SIMPLE_GPU_TIMER)")
    return p


def config_from_args(args: argparse.Namespace) -> DecoderConfig:
    kwargs = dict(
        search_step=args.search_step,
        search_width=args.search_width,
        scan_depth=args.scan_depth,
        read_mode=args.read_mode,
        analytic_method=args.analytic_method,
        nbadsync_threshold=args.nbadsync_threshold,
        max_survivors=args.max_survivors,
        candidates_per_pattern=args.candidates_per_pattern,
        survivor_prefilter=args.survivor_prefilter,
        window_batch=args.window_batch,
        scan_decimation=args.scan_decimation,
    )
    if args.center_frequency is not None:
        kwargs["center_frequency"] = args.center_frequency
    return DecoderConfig.create(**kwargs)


def print_banner(cfg: DecoderConfig, out=None) -> None:
    """Actual-parameters banner (main.cu:233-252)."""
    out = out if out is not None else sys.stderr
    mode = "16-bit signed real" if cfg.read_mode == 1 else "2x8-bit signed IQ"
    lines = [
        "Actual parameters:",
        f"Center Frequency: {cfg.center_frequency:g}Hz",
        f"Search Step: {cfg.search_step:g}Hz",
        f"Search Width: {cfg.search_width:g}Hz",
        f"Scan Depth: {cfg.scan_depth}",
        f"Left Boundary: {cfg.left_bound:g}Hz",
        f"Right Boundary: {cfg.right_bound:g}Hz",
        f"Read Mode: ({mode})",
    ]
    if cfg.read_mode == 1:
        lines.append(f"Analytic Method: {cfg.analytic_method}")
    lines += [
        f"Badsync Threshold: {cfg.nbadsync_threshold}",
        f"Frequency channels: {cfg.num_freqs}",
        f"Candidate slots: {cfg.num_candidates}",
        f"LDPC survivor batch: {cfg.max_survivors}",
        f"Scan lag grid: every {cfg.scan_decimation} sample(s)",
        "",
    ]
    print("\n".join(lines), file=out)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    # Import JAX lazily so --help stays instant.
    from .runtime.backend import (NoDeviceError, enable_persistent_cache,
                                  use_platform)

    try:
        use_platform(args.platform)
    except NoDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    print_banner(cfg)
    enable_persistent_cache()
    from .runtime import StreamDecoder
    from .runtime import native
    from .runtime.metrics import ScopedMetric, SimpleTimer
    from .runtime.stream import window_stream

    decoder = StreamDecoder(cfg)
    stdin = sys.stdin.buffer

    # Prefer the native C++ framer (built on demand); NumPy fallback otherwise.
    if native.available():
        windows = native.native_window_stream(stdin, cfg.read_mode)
    else:
        windows = window_stream(stdin, cfg.read_mode)

    def emit(results, ms: float, n_windows: int):
        budget = C.LOOP_SOFT_BUDGET_MS * n_windows
        if ms > budget:
            print(
                f"Warning: Working loop takes too much time: {ms:.0f} ms"
                f" of {budget:.0f} ms max.",
                file=sys.stderr,
            )
        for item in results:
            print(item.format_line(), flush=True)

    import time

    import jax

    t_start = time.perf_counter()
    t_first = None  # wall clock when the first results were emitted

    def first_done():
        nonlocal t_first
        if t_first is None:
            t_first = time.perf_counter()
            print(f"First results (compile + run): {t_first - t_start:.2f} s",
                  file=sys.stderr)

    if args.profile_dir:
        jax.profiler.start_trace(args.profile_dir)

    if cfg.window_batch <= 1:
        # depth-1 pipelining: the next window's device work is dispatched
        # before we block on the previous one's results, so host post-
        # processing overlaps device compute (the reference's loop is fully
        # synchronous, main.cu:468-471). ScopedMetric spans mirror the
        # reference's per-stage instrumentation (main.cu:210-479), enabled
        # by MSK144_TPU_METRICS=1.
        timer = SimpleTimer()
        win_iter = iter(windows)
        while True:
            loop_span = ScopedMetric("working_loop")
            with ScopedMetric("ingest"):
                window = next(win_iter, None)
            if window is None:
                loop_span.stop()
                break
            with ScopedMetric("submit"):
                decoder.submit(window)
            if decoder.in_flight > 1:
                with ScopedMetric("collect"):
                    results = decoder.collect()
                first_done()
                emit(results, timer.milliseconds_elapsed(), 1)
                timer = SimpleTimer()
            loop_span.stop()
        while decoder.in_flight:
            with ScopedMetric("collect"):
                results = decoder.collect()
            first_done()
            emit(results, timer.milliseconds_elapsed(), 1)
            timer = SimpleTimer()
    else:
        # Throughput mode: decode window_batch windows per device call, with
        # up to pipeline_depth batches' DEVICE calls in flight on a worker
        # pool (each worker's dispatch+fetch round trips overlap the
        # others'), while post-processing/emission stays strictly in stream
        # order on this thread. The batch shape is fixed (one jit compile);
        # the stream tail is zero-padded and its pad results dropped.
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        depth = max(1, args.pipeline_depth)
        pool = ThreadPoolExecutor(max_workers=depth)
        pending: deque = deque()  # (future, n_valid) FIFO
        n_done = 0  # windows post-processed so far
        t_steady = None  # wall clock at first batch completion
        last_done = None  # wall clock at previous batch completion

        def drain_one():
            nonlocal n_done, t_steady, last_done
            fut, n = pending.popleft()
            with ScopedMetric("device_wait_transfer"):
                res = fut.result()
            now = time.perf_counter()
            ms = 0.0 if last_done is None else (now - last_done) * 1e3
            last_done = now
            if t_steady is None:
                t_steady = now  # first batch = compile; exclude from steady state
                first_done()
            else:
                n_done += n
            with ScopedMetric("postprocess"):
                for results in decoder.postprocess_batch(res, n):
                    emit(results, 0.0, 1)
            emit([], ms, n)

        def submit(batch_np: np.ndarray, n_valid: int):
            # gate on batches still COMPUTING, not on batches awaiting
            # post-processing: blocking until the OLDEST future finishes
            # (strict FIFO) would idle every worker behind one slow batch —
            # head-of-line blocking that amplifies host-link latency
            # variance. Completed results just wait in the deque (bounded
            # by 4*depth) until their stream-order turn.
            while (sum(not f.done() for f, _ in pending) >= depth
                   or len(pending) >= 4 * depth):
                drain_one()
            pending.append((pool.submit(decoder.decode_to_host, batch_np),
                            n_valid))
            # opportunistically emit completed batches without blocking
            while pending and pending[0][0].done():
                drain_one()

        batch: list = []
        for window in windows:
            batch.append(window)
            if len(batch) == cfg.window_batch:
                submit(np.stack(batch), cfg.window_batch)
                batch = []
        if batch:
            n = len(batch)
            pad = [np.zeros_like(batch[0])] * (cfg.window_batch - n)
            submit(np.stack(batch + pad), n)
        while pending:
            drain_one()
        pool.shutdown()
        if n_done and t_steady is not None and last_done is not None \
                and last_done > t_steady:
            wall = last_done - t_steady
            ms_per = wall / n_done * 1e3
            rtf = (n_done * C.HOP_LEN) / wall / C.SAMPLE_RATE
            print(
                f"Throughput: {n_done} windows in {wall:.2f} s = "
                f"{ms_per:.3f} ms/window ({rtf:,.1f}x real time, "
                f"steady-state after first batch)",
                file=sys.stderr,
            )

    if args.profile_dir:
        jax.profiler.stop_trace()
        print(f"Profiler trace written to {args.profile_dir}", file=sys.stderr)
    stats = jax.devices()[0].memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        print(f"Device peak memory: {stats['peak_bytes_in_use']} bytes",
              file=sys.stderr)

    print("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
