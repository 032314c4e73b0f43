"""StreamDecoder: the host driver around the jitted decode pipeline.

Counterpart of the reference's do_decode + JTdecode host loop
(/root/reference/src/main.cu:428-532): run the device pipeline on a raw
window, then on the host unpack each decoded 77-bit payload to text (with a
content-keyed memo cache, main.cu:448,497-504 — minus its broken comparator,
see SURVEY.md quirks), track SNR, and deduplicate through the ResultFilter.

Supports depth-1 async pipelining: `submit()` launches the device work and
returns immediately (JAX async dispatch); `collect()` blocks on the transfer
and does host post-processing. The reference's loop is fully synchronous
(main.cu:468-471) — overlapping device compute with host unpack of the
previous window is a free win.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import constants as C
from ..config import DecoderConfig
from ..ops import pipeline
from ..protocol import msg77
from .metrics import ScopedMetric
from .result_filter import ResultFilter, ResultItem
from .snr import SNRTracker


#: Cap on the content-keyed unpack memo. A stream decoder runs indefinitely
#: (main.cu's loop is while-not-EOF); distinct 77-bit payloads are rare in
#: practice (noise survivors fail the plausibility gate and cache as misses),
#: but a cap keeps the worst case bounded. FIFO eviction: recurrence of the
#: *same* message dominates, so recency tracking buys nothing here.
DECODE_CACHE_MAX = 4096


class StreamDecoder:
    def __init__(self, cfg: DecoderConfig,
                 survivor_capacity: Optional[int] = None,
                 freqs: Optional[np.ndarray] = None):
        # survivor_capacity: LDPC rows actually decoded per window —
        # cfg.max_survivors on a single device, K * n_freq_shards on a mesh
        # (each shard decodes its own top-K); the overflow warning compares
        # the global survivor count against it. freqs: the candidate-index
        # frequency grid when it differs from cfg.freqs (a mesh pads the
        # grid for shard divisibility; pad channels never produce results
        # but shift nothing — real channels keep their indices).
        self.cfg = cfg
        self.survivor_capacity = (cfg.max_survivors if survivor_capacity
                                  is None else survivor_capacity)
        # with the xb-prefilter active, survivor counts are LOWER BOUNDS:
        # nbadsync exists only post-demod, and only prefiltered candidates
        # are demodulated, so candidates outside the prefilter that would
        # have passed the threshold are uncountable without the full demod
        # the prefilter exists to avoid. The warning text says "at least".
        # On a mesh the prefilter resolves per SHARD against the local
        # candidate count (survivor_capacity / max_survivors shards over
        # the possibly padded grid), not the global one.
        n_shards = max(1, self.survivor_capacity // max(cfg.max_survivors, 1))
        grid_f = len(cfg.freqs) if freqs is None else len(freqs)
        local_nc = (-(-grid_f // n_shards)
                    * cfg.scan_depth * cfg.candidates_per_pattern)
        self._count_is_lower_bound = pipeline.resolve_prefilter(
            cfg, local_nc) > 0
        self.snr_tracker = SNRTracker()
        self.result_filter = ResultFilter()
        self.hashes = msg77.CallsignHashTable()
        self._decode_cache: Dict[bytes, Tuple[bool, str]] = {}
        self._freqs = cfg.freqs if freqs is None else freqs
        self._pending: deque = deque()  # in-flight WindowDecodeResults (FIFO)
        # survivor-overflow warning aggregation (see _warn_overflow):
        # global-capacity and per-shard overflows tracked separately so the
        # rate-limited aggregate cites the right bound
        self._ovf_count = 0
        self._ovf_max_global = 0
        self._ovf_max_shard = 0
        self._ovf_window = 0

    # -- device side ------------------------------------------------------

    def submit(self, raw_window: np.ndarray) -> None:
        """Launch the device pipeline on one raw window (async dispatch).
        Multiple windows may be in flight; collect() drains them in order."""
        raw = np.asarray(raw_window)[None, :]  # batch of 1
        self._pending.append(pipeline.decode_raw(raw, self.cfg))

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def collect(self) -> List[ResultItem]:
        """Block on the oldest in-flight window, post-process, return its
        deduped results."""
        assert self._pending, "no window submitted"
        with ScopedMetric("device_wait_transfer"):
            res = jax_to_host(self._pending.popleft())
        with ScopedMetric("postprocess"):
            return self._postprocess(res)

    def decode_block(self, raw_window: np.ndarray) -> List[ResultItem]:
        """Synchronous submit+collect of one window."""
        self.submit(raw_window)
        return self.collect()

    def decode_many(self, raw_batch: np.ndarray,
                    n_valid: Optional[int] = None) -> List[List[ResultItem]]:
        """Decode a (B, raw_len) batch in one device call; post-process each
        window in stream order (SNR EMA and dedup scopes stay sequential).
        n_valid < B ignores trailing pad windows (batch-tail flush)."""
        res = self.decode_to_host(raw_batch)
        n = len(raw_batch) if n_valid is None else n_valid
        return self.postprocess_batch(res, n)

    def decode_to_host(self, raw_batch: np.ndarray) -> "pipeline.WindowDecodeResult":
        """Device decode of a (B, raw_len) batch + blocking result fetch,
        WITHOUT host post-processing. Thread-safe (pure function of the
        batch), so a pipelined driver can run several batches' device calls
        concurrently — overlapping each call's dispatch+fetch round trips —
        while post-processing (stateful: SNR EMA, dedup scope) stays
        sequential on the caller."""
        return jax_to_host(pipeline.decode_raw(np.asarray(raw_batch), self.cfg))

    def postprocess_batch(self, res: "pipeline.WindowDecodeResult",
                          n_valid: int) -> List[List[ResultItem]]:
        """Sequential host post-processing of a fetched batch result, in
        stream order. NOT thread-safe; call from one thread, batches in
        stream order."""
        return [self._postprocess_one(res, b) for b in range(n_valid)]

    # -- host side --------------------------------------------------------

    def _unpack_cached(self, bits77: np.ndarray) -> Tuple[bool, str]:
        key = np.packbits(bits77).tobytes()
        hit = self._decode_cache.get(key)
        if hit is not None:
            return hit
        if msg77.plausible_message_type(bits77):
            out = msg77.unpack77(bits77, self.hashes)
        else:
            out = (False, "")
        if len(self._decode_cache) >= DECODE_CACHE_MAX:
            self._decode_cache.pop(next(iter(self._decode_cache)))
        self._decode_cache[key] = out
        return out

    def _postprocess(self, res) -> List[ResultItem]:
        return self._postprocess_one(res, 0)

    #: windows between aggregated overflow warnings (the first overflow
    #: prints immediately; on a deep-scan noise band EVERY window can
    #: overflow, and one stderr line per 216 ms hop is log spam)
    OVERFLOW_WARN_EVERY = 256

    def _warn_overflow(self, n_surv: int, shard_surv: int = 0) -> None:
        """Never silently truncate: the reference BP-decodes every
        under-threshold survivor; we decode the best max_survivors by exact
        (nbadsync, xb) order and say so — immediately on first occurrence,
        then as a rate-limited aggregate.

        Two triggers (either suffices): the GLOBAL survivor count exceeding
        the total LDPC capacity, and — on a mesh, where each frequency
        shard truncates at its own top-K — any single shard exceeding its
        LOCAL K (a pileup clustered in one shard can overflow that shard
        while the global sum stays under K * n_shards). When the prefilter
        is active both counts are lower bounds (see config.py)."""
        self._ovf_window += 1
        shard_over = shard_surv > self.cfg.max_survivors
        if n_surv > 0 or shard_over:
            self._ovf_count += 1
            self._ovf_max_global = max(self._ovf_max_global, n_surv)
            if shard_over:
                self._ovf_max_shard = max(self._ovf_max_shard, shard_surv)
        if ((self._ovf_count == 1 and (n_surv > 0 or shard_over))
                or (self._ovf_window >= self.OVERFLOW_WARN_EVERY
                    and self._ovf_count)):
            mx = max(self._ovf_max_global, self._ovf_max_shard)
            agg = (f" ({self._ovf_count} of the last {self._ovf_window} "
                   f"windows overflowed; max {mx})"
                   if self._ovf_window > 1 else "")
            lb = "at least " if self._count_is_lower_bound else ""
            # cite the bound that was actually exceeded (the aggregate path
            # may be reporting past windows: prefer the global-capacity
            # breach, fall back to the per-shard one)
            g = n_surv if n_surv > 0 else self._ovf_max_global
            if g > 0:
                head = (f"{lb}{g} sync survivors exceed the LDPC batch "
                        f"(max_survivors={self.survivor_capacity})")
            else:
                s = shard_surv if shard_over else self._ovf_max_shard
                head = (f"{lb}{s} sync survivors in one frequency "
                        f"shard exceed its local batch "
                        f"(max_survivors={self.cfg.max_survivors} per shard)")
            print(
                f"Warning: {head}; decoding the best survivors by "
                f"(nbadsync, xb).{agg}",
                file=sys.stderr,
            )
            if self._ovf_window >= self.OVERFLOW_WARN_EVERY:
                self._ovf_count = self._ovf_window = 0
                self._ovf_max_global = self._ovf_max_shard = 0

    def _postprocess_one(self, res, b: int) -> List[ResultItem]:
        """Host post-processing for window b of a batched result."""
        n_surv = int(res.num_survivors[b])
        shard_surv = int(res.shard_survivors[b])
        self._warn_overflow(n_surv if n_surv > self.survivor_capacity else 0,
                            shard_surv)
        self.snr_tracker.process_powers(res.block_power[b])
        self.result_filter.block_begin()
        found = np.asarray(res.found[b])
        with ScopedMetric("unpack77"):
            for k in np.nonzero(found)[0]:
                bits77 = pipeline.unpack_message_bits(res.message_bits[b][k])
                ok, text = self._unpack_cached(bits77)
                if not ok:
                    continue
                fi, pi, _ = pipeline.unpack_candidate_index(self.cfg, int(res.cand_index[b][k]))
                self.result_filter.put_message(
                    snr=self.snr_tracker.snr_i,
                    f0=float(self._freqs[fi]),
                    num_avg=int(C.PATTERN_NUM_AVG[pi]),
                    nbadsync=int(res.nbadsync[b][k]),
                    pattern_idx=pi,
                    message=text,
                )
        with ScopedMetric("result_filter"):
            self.result_filter.block_end()
            return self.result_filter.block_result()


def jax_to_host(res) -> "pipeline.WindowDecodeResult":
    """Materialize every leaf of a WindowDecodeResult on the host.

    All leaves start their device->host copies first (copy_to_host_async),
    THEN each is materialized, so the 12 leaves' transfers overlap instead
    of running one blocking round trip after another."""
    for x in res:
        if hasattr(x, "copy_to_host_async"):
            x.copy_to_host_async()
    return type(res)(*(np.asarray(x) for x in res))
