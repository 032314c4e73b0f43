"""Typed decoder configuration.

One config object covers what the reference spreads over three tiers: CLI
options (/root/reference/src/main.cu:136-190), compile-time constants
(src/common.h:14-47), and CMake defines (CMakeLists.txt:44-49). It is frozen
and hashable so it can be a static argument to jitted pipelines.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from . import constants as C


@dataclass(frozen=True)
class DecoderConfig:
    # --- CLI-equivalent options (defaults mirror main.cu:122-133 code, not
    # its stale help text) ---
    center_frequency: float = 1500.0
    search_step: float = 2.0
    search_width: float = 200.0
    scan_depth: int = 4
    read_mode: int = 1  # 1 = 16-bit audio, 2 = 8-bit IQ
    analytic_method: int = 2  # 1 = FFT Hilbert, 2 = shift+FIR+shift
    nbadsync_threshold: int = 1

    # --- Framework knobs (no reference equivalent) ---
    max_survivors: int = 256  # static LDPC batch: top-K candidates by
    # (nbadsync, xb) under per-pattern quotas; replaces the reference's
    # dynamic stream compaction (src/index_kernel.cuh) which XLA's static
    # shapes cannot express. The staggered busy-band battery (>3400 genuine
    # survivors/window, tests/test_busyband.py) reproduces at K=256 every
    # per-message (num_avg, nbadsync) the unconstrained decode-everything
    # run prints. K=128 starts losing lowest-num_avg rows under pileups
    # (per-pattern quota ~21). The BP batch and the 2K-deep demod prefilter
    # both scale with K.
    max_results: int = 64  # result slots returned per window: the K-survivor
    # table is compacted found-first on device so only decodes (plus the best
    # non-decodes for diagnostics) cross the host link
    candidates_per_pattern: int = 8  # top-k candidate lags demodulated per
    # (frequency, pattern). The reference hard-codes 8 (common.h:34); the scan
    # emits candidates in strictly descending xb order, so k < 8 demodulates
    # only the best-sync k lags of each slot. Decodable signals essentially
    # always rank first at their own (freq, pattern) — see
    # tools/sensitivity_sweep.py results in ARCHITECTURE.md — so lowering k
    # trades diagnostics-row parity (chance noise survivors at xb rank > k
    # are not tracked) for a proportional cut of the demod's
    # per-candidate frame gather and matched-filter work.
    survivor_prefilter: int | None = None  # demodulate only the top-P
    # candidates by scan xb (the |sync correlation| the demod itself would
    # re-derive as its carrier magnitude), instead of all F*depth*8. The
    # reference demodulates everything; every realistically decodable
    # candidate sits far up the xb order (decodes require a strong sync
    # correlation by construction). None = auto: 2x max_survivors, on every
    # backend. 0 = off (full demod, exact reference candidate-set
    # semantics). When active, num_survivors counts threshold-passing
    # candidates within the prefiltered set (a lower bound on the true
    # count).
    prefilter_per_cell: int = 2  # cap on prefiltered candidates per (freq,
    # pattern) cell. One transmission occupies one sync lag per cell, so
    # same-cell slots beyond the best are noise duplicates; capping shrinks
    # the prefilter's global top_k from F*depth*8 to F*depth*per_cell
    # candidates (deep scan: 24,048 -> 6,012). >= 2 keeps two overlapping
    # same-frequency transmissions alive; 8 (= all slots) disables the cap.
    # Ignored when the prefilter is off.
    window_batch: int = 1  # windows decoded per device call
    scan_decimation: int = 4  # coarse lag grid: candidate selection
    # keeps every dec-th lag (dec in {1, 2, 4}) instead of all 5184. Every
    # roll the pattern combine needs (864m and 336) is divisible by 4, so
    # the decimated field is EXACT at its lags — candidates can only land
    # up to dec-1 samples off the full-resolution argmax, which the demod
    # absorbs. 1 = the full-resolution grid, matching the reference's
    # per-lag search exactly (/root/reference/src/scan_kernel.cuh:85-124).

    def __post_init__(self):
        d = min(max(self.scan_depth, 1), C.SCAN_DEPTH_MAX)
        object.__setattr__(self, "scan_depth", d)
        if self.read_mode not in (1, 2):
            raise ValueError(f"read_mode must be 1 or 2, got {self.read_mode}")
        if self.analytic_method not in (1, 2):
            raise ValueError(f"analytic_method must be 1 or 2, got {self.analytic_method}")
        if not 1 <= self.candidates_per_pattern <= C.NUM_CANDIDATES_PER_PATTERN:
            raise ValueError(
                f"candidates_per_pattern must be in [1, {C.NUM_CANDIDATES_PER_PATTERN}],"
                f" got {self.candidates_per_pattern}")
        if not 1 <= self.prefilter_per_cell <= C.NUM_CANDIDATES_PER_PATTERN:
            raise ValueError(
                f"prefilter_per_cell must be in [1, {C.NUM_CANDIDATES_PER_PATTERN}],"
                f" got {self.prefilter_per_cell}")
        if self.scan_decimation not in (1, 2, 4):
            raise ValueError(
                f"scan_decimation must be 1, 2 or 4, got {self.scan_decimation}")

    @classmethod
    def create(cls, **kwargs) -> "DecoderConfig":
        """Create with the reference's default center frequency per read mode
        (main.cu:192-208): 1500 Hz for audio, 0 Hz for IQ."""
        if "center_frequency" not in kwargs:
            kwargs["center_frequency"] = 0.0 if kwargs.get("read_mode", 1) == 2 else 1500.0
        return cls(**kwargs)

    def replace(self, **kwargs) -> "DecoderConfig":
        return dataclasses.replace(self, **kwargs)

    @property
    def freqs(self) -> np.ndarray:
        return C.freq_grid(self.center_frequency, self.search_width, self.search_step)

    @property
    def num_freqs(self) -> int:
        return len(self.freqs)

    @property
    def num_candidates(self) -> int:
        return self.num_freqs * self.scan_depth * self.candidates_per_pattern

    @property
    def left_bound(self) -> float:
        return float(self.freqs[0])

    @property
    def right_bound(self) -> float:
        return float(self.freqs[-1])
