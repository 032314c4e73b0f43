"""End-to-end jitted decode pipeline for one (or a batch of) 5184-sample
windows: preprocessing -> scan -> demod -> survivor selection -> LDPC -> CRC.

This is the counterpart of the reference's do_decode driver
(/root/reference/src/main.cu:428-532) plus its four kernel launches, fused
under one jax.jit with static shapes throughout. The reference's dynamic
survivor compaction (index_kernel) becomes a top-K selection keyed on
(nbadsync ascending, xb descending); K = cfg.max_survivors.

Everything device-side returns fixed-shape arrays; message-text unpacking and
dedup happen host-side (runtime/), as in the reference (L6 layer).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..config import DecoderConfig
from . import analytic, bp_kernel, ldpc, scan, softbits

_N = C.WINDOW_LEN


class WindowDecodeResult(NamedTuple):
    """Fixed-shape per-window outputs; K = cfg.max_results rows."""

    cand_index: jnp.ndarray  # (K,) int32 flat index into (F, P, 8)
    valid: jnp.ndarray  # (K,) bool: nbadsync <= threshold
    found: jnp.ndarray  # (K,) bool: LDPC+CRC success
    message_bits: jnp.ndarray  # (K, 10) uint8: the 77 payload bits PACKED
    # in np.packbits order (bit i of the payload = bit 7-i%8 of byte i//8;
    # unpack with pipeline.unpack_message_bits). Packed on device: this
    # field is 74% of the result struct's bytes, and the result is fetched
    # to the host every window (main analog: result_keeper.cuh:123-130).
    nbadsync: jnp.ndarray  # (K,) int32
    xb: jnp.ndarray  # (K,) float32
    pos: jnp.ndarray  # (K,) int32
    ldpc_iterations: jnp.ndarray  # (K,) int32
    hard_errors: jnp.ndarray  # (K,) int32
    num_survivors: jnp.ndarray  # () int32: how many passed the threshold
    shard_survivors: jnp.ndarray  # () int32: largest SINGLE-SHARD survivor
    # count (== num_survivors on one device; lax.pmax over the freq axis on
    # a mesh). Truncation happens per shard at its local top-K, so a pileup
    # clustered in one shard can overflow K while the global sum stays
    # under K * n_shards — the overflow warning must see the shard maximum,
    # not just the sum (ADVICE r4 medium).
    block_power: jnp.ndarray  # (8,) float32 sub-block powers for SNR tracking


def pack_message_bits(bits77: jnp.ndarray) -> jnp.ndarray:
    """(..., 77) {0,1} values -> (..., 10) uint8, np.packbits bit order."""
    b = jnp.pad(bits77.astype(jnp.int32), [(0, 0)] * (bits77.ndim - 1) + [(0, 3)])
    b = b.reshape(b.shape[:-1] + (10, 8))
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
    return jnp.sum(b * w, axis=-1).astype(jnp.uint8)


def unpack_message_bits(packed) -> np.ndarray:
    """Host side: (..., 10) uint8 -> (..., 77) int8 payload bits."""
    arr = np.asarray(packed, dtype=np.uint8)
    return np.unpackbits(arr, axis=-1)[..., :77].astype(np.int8)


def preprocess(raw: jnp.ndarray, cfg: DecoderConfig) -> jnp.ndarray:
    """Raw input window -> analytic complex64 window (..., 5184).

    read_mode 1: raw is (..., 5184) int16/float audio, RMS-normalized then
    converted (main.cu:301-332). read_mode 2: raw is (..., 10368) interleaved
    int8 IQ, scaled by 1/128 then low-pass filtered (main.cu:334-381; the
    reference applies no RMS normalization in IQ mode).
    """
    if cfg.read_mode == 1:
        x = analytic.rms_normalize(raw)
        if cfg.analytic_method == 1:
            return analytic.analytic_method1(x)
        return analytic.analytic_method2(x)
    z = raw.astype(jnp.float32) / 128.0
    zc = jax.lax.complex(z[..., 0::2], z[..., 1::2])
    return analytic.iq_filter(zc)


def block_powers(c: jnp.ndarray) -> jnp.ndarray:
    """(8,) sub-block signal powers of one analytic window, matching the SNR
    tracker's host loop (/root/reference/src/snr_tracker.cu:21-33)."""
    return jnp.sum(jnp.abs(c.reshape(8, _N // 8)) ** 2, axis=-1).astype(jnp.float32)


def select_survivors(nbad_f: jnp.ndarray, xb_f: jnp.ndarray, k: int) -> jnp.ndarray:
    """Top-k candidate indices in EXACT lexicographic (nbadsync asc, xb desc)
    order, via a two-key sort. xb >= 0 (a magnitude), so its int32 bitcast is
    order-isomorphic; a float composite key would quantize the xb tie-break
    away (f32 ulp at 1e9 is 64). The reference BP-decodes every
    under-threshold survivor (index_kernel.cuh:22-75); with a static K this
    ordering decides truncation, so it must be exact."""
    nc = nbad_f.shape[0]
    xb_bits = jax.lax.bitcast_convert_type(jnp.maximum(xb_f, 0.0), jnp.int32)
    _, _, sorted_idx = jax.lax.sort(
        (nbad_f.astype(jnp.int32), -xb_bits, jnp.arange(nc, dtype=jnp.int32)),
        num_keys=2)
    return sorted_idx[:k]


def resolve_prefilter(cfg: DecoderConfig, nc: int) -> int:
    """Effective xb-prefilter size: 0 = full demod. Auto (None) is 2x
    max_survivors on every backend — the setting the busy-band battery
    validates (tests/test_busyband.py); any value that would not shrink the
    nc-candidate demod disables it."""
    p = cfg.survivor_prefilter
    if p is None:
        p = 2 * cfg.max_survivors
    return 0 if p <= 0 or p >= nc else p


def prefilter_per_cell(cfg: DecoderConfig, cells: int, pre: int) -> int:
    """The per-cell cap, raised until the capped grid still offers >= pre
    candidates to choose from."""
    per_cell = cfg.prefilter_per_cell
    while per_cell < cfg.candidates_per_pattern and cells * per_cell < pre:
        per_cell += 1
    return per_cell


def prefilter_select(xb: jnp.ndarray, pos: jnp.ndarray, pre: int,
                     per_cell: int,
                     chan_valid: jnp.ndarray | None):
    """Top candidates by scan xb: at most `per_cell` per (freq, pattern)
    cell, then a per-PATTERN top-k quota summing to `pre`. Returns
    (xb_sel, pos_sel, f_idx, p_idx, flat_idx), each (pre,).

    The reference demodulates every candidate and filters by nbadsync only
    (/root/reference/src/index_kernel.cuh:22-75); the xb prefilter is this
    repo's static-shape stand-in. Two structural rules keep it faithful:

      - per-cell cap: one transmission occupies ONE sync lag per (freq,
        pattern) cell, so same-cell slots beyond the best are noise
        duplicates; >= 2 keeps two overlapping same-frequency transmissions
        alive.
      - per-pattern quotas: xb grows with coherent averaging, so a single
        global top-`pre` floods with high-num_avg candidates and can starve
        the pattern-0/1 candidates the reference would decode (it prints the
        LOWEST num_avg per message, result_filter.cpp:59-72). A quota of
        ~pre/P per pattern makes each pattern's candidates compete only
        against same-gain noise.

    Both rules also make the selection cheap: P top_ks over F*per_cell
    candidates instead of one over F*P*8 (deep scan: 6 x 1,002 vs 24,048).
    """
    F, P, S = xb.shape
    if chan_valid is not None:
        xb = jnp.where(chan_valid[:, None, None], xb, 0.0)
    cells = F * P
    # the scan emits the S slots of a cell in descending xb order
    # (lax.top_k in ops/scan), so the per-cell top-k is a slice, not a top_k
    xb2 = xb.reshape(cells, S)[:, :per_cell]
    pos2 = pos.reshape(cells, S)[:, :per_cell]
    # pack (flat candidate index, pos) into one int32 carrier so the
    # post-top_k load is a single small gather: flat < 24048, pos < 8192
    flat2 = (jnp.arange(cells, dtype=jnp.int32)[:, None] * S
             + jnp.arange(per_cell, dtype=jnp.int32))
    meta2 = flat2 * 8192 + pos2
    # pattern-major views: row p holds all F*per_cell candidates of pattern p
    xb_p = xb2.reshape(F, P, per_cell).transpose(1, 0, 2).reshape(P, -1)
    meta_p = meta2.reshape(F, P, per_cell).transpose(1, 0, 2).reshape(P, -1)
    quota = split_quota(pre, P)
    # per-pattern top-quota via ONE two-operand sort carrying meta along
    # (no index gather after the selection). The stable sort keeps
    # argmax-first tie order and the per-pattern quota reads are static row
    # slices.
    xb_neg, meta_sorted = jax.lax.sort((-xb_p, meta_p), dimension=1,
                                       num_keys=1)
    xb_sel = jnp.concatenate([-xb_neg[p, : quota[p]] for p in range(P)])
    meta_sel = jnp.concatenate([meta_sorted[p, : quota[p]]
                                for p in range(P)])
    flat_idx = meta_sel // 8192
    pos_sel = meta_sel - flat_idx * 8192
    per_f = P * S
    f_idx = flat_idx // per_f
    p_idx = flat_idx % per_f // S
    return xb_sel, pos_sel, f_idx, p_idx, flat_idx


# select_survivors_topk exactness domain: xb clamped into [2^-4, 2^20).
_XB_LO = 2.0 ** -4
_XB_HI = float(np.float32(2.0 ** 20) * (1.0 - 2.0 ** -24))
# fast path needs (threshold + 2) * 24 exponent doublings below 2^-4 to stay
# in normal f32 range (accelerators may flush subnormals): threshold <= 4.
TOPK_MAX_THRESHOLD = 4


def select_survivors_topk(nbad_f: jnp.ndarray, xb_f: jnp.ndarray, k: int,
                          threshold: int,
                          mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Fast exact survivor selection via one f32 top_k instead of a full
    two-key sort over every candidate.

    Key = clamp(xb, 2^-4, 2^20) * 2^(-24 * min(nbad, threshold+1)): the
    exponent shift is exact (power-of-two multiply, no underflow for
    threshold <= 4), so ordering within each nbadsync class is the exact f32
    xb order, and classes cannot interleave (24 doublings cover the clamp
    range, and the 2^20*(1-2^-24) ceiling keeps the boundary strict). Two
    deviations from select_survivors, neither visible in decode output:
      - candidates below the survivor threshold all land in one bucket, so
        DIAGNOSTICS rows (never BP-decoded, never printed by the reference —
        main.cu:480-525 reads only is_message_present items) order by xb
        without the nbadsync tie-break;
      - xb outside [2^-4, 2^20) saturates and ties within its class (xb is
        the magnitude of a >=504-sample unit-RMS correlation; values beyond
        that range do not occur in RMS-normalized input).
    """
    cls = jnp.minimum(nbad_f, threshold + 1).astype(jnp.int32)
    # 2^(-24*cls) built from exponent bits: exact power of two
    mul = jax.lax.bitcast_convert_type(
        ((127 - 24 * cls) << 23).astype(jnp.int32), jnp.float32)
    key = jnp.clip(xb_f, _XB_LO, _XB_HI) * mul
    if mask is not None:
        key = jnp.where(mask, key, 0.0)  # real keys are > 0: masked rank last
    _, idx = jax.lax.top_k(key, k)
    return idx


def select_survivors_quota(nbad_f: jnp.ndarray, xb_f: jnp.ndarray, k: int,
                           threshold: int, quotas: list[tuple[int, object]]
                           ) -> jnp.ndarray:
    """Survivor selection with a per-pattern slot quota (summing to k).

    The reference BP-decodes EVERY under-threshold survivor
    (/root/reference/src/index_kernel.cuh:22-75) and the host prints the
    lowest-num_avg decode per message (result_filter.cpp:59-72). With a
    static K, a single (nbadsync, xb) ranking starves low-averaging patterns
    whenever survivors overflow K — xb grows with coherent averaging, so the
    nbadsync=0 class orders high-num_avg first and a strong signal's
    pattern-0 candidates (the ones the reference would print) fall off the
    batch. A per-pattern quota makes candidates compete only against
    same-gain rivals; within each pattern the ordering is the exact
    (nbadsync, xb) key.

    quotas: list of (quota, segment) where segment is either a slice
    (pattern-major contiguous run) or a boolean mask over the flat axis.
    Slice segments are small (~pre/P rows), so they use the provably ordered
    two-key sort — after a fused-graph top_k was once observed returning
    rank order (see the result-compaction note below), correctness-critical
    ordering avoids top_k where a sort is affordable. Mask segments span the
    full candidate axis (non-prefilter path), where the sort over every
    candidate is the expensive form; the packed-key top_k stays there.
    """
    parts = []
    for q, seg in quotas:
        if isinstance(seg, slice):
            idx = select_survivors(nbad_f[seg], xb_f[seg], q)
            parts.append(idx + seg.start)
        else:
            parts.append(select_survivors_topk(nbad_f, xb_f, q, threshold,
                                               mask=seg))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def split_quota(total: int, parts: int) -> list[int]:
    return [total // parts + (1 if p < total % parts else 0)
            for p in range(parts)]


class PreparedWindow(NamedTuple):
    """Per-window state between survivor selection and the BP stage (the
    split point lets decode_windows run BP once on the flat batch of every
    window's survivors)."""

    llr: jnp.ndarray  # (K, 128) f32
    valid: jnp.ndarray  # (K,) bool
    nbad_k: jnp.ndarray  # (K,) int32
    xb_k: jnp.ndarray  # (K,) f32
    pos_k: jnp.ndarray  # (K,) int32
    cand_k: jnp.ndarray  # (K,) int32
    num_survivors: jnp.ndarray  # () int32
    block_power: jnp.ndarray  # (8,) f32


def prepare_window(c: jnp.ndarray, freqs, cfg: DecoderConfig,
                   chan_valid: jnp.ndarray | None = None) -> PreparedWindow:
    """One analytic window (5184,) complex64 -> top-K survivor LLRs + meta
    (everything before the LDPC stage).

    `freqs` is either a static tuple (single-device: tables become jit
    constants) or a tables.FreqTables of arrays (shard_map: each device gets
    its frequency-axis slice). All shapes derive from the table arrays so the
    same code serves both paths.

    `chan_valid` (F,) bool optionally masks frequency channels out of survivor
    selection (sharding pads the grid past the configured right boundary to
    make F divisible by the mesh; those channels must not compete for
    survivor slots or report f0 outside the requested search width).
    """
    with jax.named_scope("scan"):
        pos, xb = scan.scan(c, freqs, cfg.scan_depth,
                            num_cand=cfg.candidates_per_pattern,
                            dec=cfg.scan_decimation)  # (F, P, k)
    F, P, S = pos.shape
    nc = F * P * S
    pre = resolve_prefilter(cfg, nc)

    if pre:
        # xb-prefilter: demodulate only the top `pre` candidates by scan xb.
        # Always the pattern-quota'd selection, even at per_cell = 8 (no
        # cell cap): a single global top-`pre` by xb would flood with
        # high-num_avg candidates and starve the pattern-0 rows the
        # reference prints (tests/test_busyband.py exercises this). Masked
        # channels rank last and get nbadsync 17 after demod, as on the
        # full path.
        with jax.named_scope("prefilter"):
            xb_f, pos_f, f_idx, p_idx, idx_map = prefilter_select(
                xb, pos, pre, prefilter_per_cell(cfg, F * P, pre),
                chan_valid)
        with jax.named_scope("demod"):
            sb_f, nbad_f = softbits.demod_survivors(c, freqs, pos_f, f_idx,
                                                    p_idx)
        if chan_valid is not None:
            nbad_f = jnp.where(chan_valid[f_idx], nbad_f, 17)
        nc_sel = pre
        pattern_major = True  # per-pattern quota runs, contiguous
    else:
        with jax.named_scope("demod"):
            sb, nbad = softbits.demod_candidates(c, freqs, cfg.scan_depth,
                                                 pos)
        if chan_valid is not None:
            # masked channels: nbadsync above any threshold, xb zeroed — they
            # can neither become survivors nor outrank real diagnostics rows
            nbad = jnp.where(chan_valid[:, None, None], nbad, 17)
            xb = jnp.where(chan_valid[:, None, None], xb, 0.0)
        xb_f = xb.reshape(nc)
        nbad_f = nbad.reshape(nc)
        pos_f = pos.reshape(nc)
        sb_f = sb.reshape(nc, 128)
        idx_map = jnp.arange(nc, dtype=jnp.int32)
        nc_sel = nc
        pattern_major = False
        p_idx = idx_map % (P * S) // S

    with jax.named_scope("select"):
        top_idx = _select_top(cfg, nbad_f, xb_f, nc_sel, P, pattern_major,
                              p_idx)
        nbad_k = nbad_f[top_idx]
        return PreparedWindow(
            llr=sb_f[top_idx], valid=nbad_k <= cfg.nbadsync_threshold,
            nbad_k=nbad_k, xb_k=xb_f[top_idx], pos_k=pos_f[top_idx],
            cand_k=idx_map[top_idx],
            num_survivors=(nbad_f <= cfg.nbadsync_threshold).sum().astype(
                jnp.int32),
            block_power=block_powers(c))


def _select_top(cfg: DecoderConfig, nbad_f, xb_f, nc_sel: int, P: int,
                pattern_major: bool, p_idx) -> jnp.ndarray:
    """Survivor indices into the (nc_sel,) candidate rows: per-pattern
    quotas where K covers every pattern, else one exact ranking."""
    k = min(cfg.max_survivors, nc_sel)
    if cfg.nbadsync_threshold <= TOPK_MAX_THRESHOLD:
        if k >= P > 1:
            # per-pattern slot quotas (see select_survivors_quota)
            if pattern_major:
                seg_sizes = split_quota(nc_sel, P)
                offs = np.cumsum([0] + seg_sizes)
                segs = [slice(int(offs[p]), int(offs[p + 1]))
                        for p in range(P)]
            else:
                segs = [p_idx == p for p in range(P)]
            top_idx = select_survivors_quota(
                nbad_f, xb_f, k, cfg.nbadsync_threshold,
                list(zip(split_quota(k, P), segs)))
        else:
            top_idx = select_survivors_topk(nbad_f, xb_f, k,
                                            cfg.nbadsync_threshold)
    else:
        top_idx = select_survivors(nbad_f, xb_f, k)
    return top_idx


def bp_stage(llr: jnp.ndarray, valid: jnp.ndarray) -> ldpc.BPResult:
    """LDPC BP + CRC on a flat survivor batch (any number of windows' K-rows
    stacked — rows are independent). Compiled for a CUDA device this is the
    fused Pallas/Triton kernel (ops/bp_kernel.py: the whole 10-iteration
    loop stays on chip); compiled for any other platform it is the plain
    reference ldpc.bp_decode. The choice is made per lowering platform, so
    one traced program serves both."""
    return jax.lax.platform_dependent(
        llr, valid, cuda=bp_kernel.bp_decode, default=ldpc.bp_decode)


def finish_window(prep: PreparedWindow, bp, cfg: DecoderConfig
                  ) -> WindowDecodeResult:
    """Result compaction for one window from its prepared state + BP output."""
    k = prep.llr.shape[0]

    # Device-side result compaction: keep only max_results slots, decodes
    # first (then best remaining survivors for diagnostics). The reference
    # copies its whole result table to the host every loop
    # (result_keeper.cuh:123-130); we ship ~R rows instead of K.
    # top_idx is already in selection order, so rank position = arange(k);
    # the two-key sort puts decodes first, rank-ordered within each group.
    # (A found*2^20 - rank int32 top_k formulation was once observed to
    # return RANK order — not key order — inside a fused graph, silently
    # dropping decodes past max_results, while behaving correctly in a
    # standalone test. The sort is provably ordered, so it stays.)
    r = min(cfg.max_results, k)
    _, sel = jax.lax.sort(
        ((~bp.found).astype(jnp.int32), jnp.arange(k, dtype=jnp.int32)),
        num_keys=2)
    sel = sel[:r]
    return WindowDecodeResult(
        cand_index=prep.cand_k[sel],
        valid=prep.valid[sel],
        found=bp.found[sel],
        message_bits=pack_message_bits(bp.codeword[sel, :77]),
        nbadsync=prep.nbad_k[sel],
        xb=prep.xb_k[sel],
        pos=prep.pos_k[sel],
        ldpc_iterations=bp.iterations[sel],
        hard_errors=bp.hard_errors[sel],
        num_survivors=prep.num_survivors,
        shard_survivors=prep.num_survivors,
        block_power=prep.block_power,
    )


def decode_window_tables(c: jnp.ndarray, freqs, cfg: DecoderConfig,
                         chan_valid: jnp.ndarray | None = None,
                         ) -> WindowDecodeResult:
    """One analytic window -> fixed-shape decode results (prepare -> BP ->
    finish; see prepare_window for the freqs/chan_valid contract)."""
    prep = prepare_window(c, freqs, cfg, chan_valid)
    bp = bp_stage(prep.llr, prep.valid)
    return finish_window(prep, bp, cfg)


def decode_window(c: jnp.ndarray, cfg: DecoderConfig) -> WindowDecodeResult:
    """Single-device decode: frequency tables are jit-constants from cfg."""
    return decode_window_tables(c, tuple(float(f) for f in cfg.freqs), cfg)


def decode_windows(c: jnp.ndarray, freqs, cfg: DecoderConfig,
                   chan_valid: jnp.ndarray | None = None
                   ) -> WindowDecodeResult:
    """Batched decode of preprocessed analytic windows (B, N) -> batched
    results — the throughput formulation shared by the single-device and
    sharded paths: everything up to survivor selection is vmap'd per window,
    then BP runs once on the whole batch's survivors (B*K rows).

    `freqs` is either a static tuple (single device: tables become jit
    constants) or a tables.FreqTables of arrays (shard_map: each device gets
    its frequency-axis slice — shapes below derive from the table arrays, so
    inside shard_map everything is sized to the LOCAL frequency slice).
    `chan_valid` masks sharding-pad channels; see prepare_window."""
    prep = jax.vmap(lambda w: prepare_window(
        w, freqs, cfg, chan_valid=chan_valid))(c)
    b, k = prep.llr.shape[0], prep.llr.shape[1]
    with jax.named_scope("bp"):
        bp_flat = bp_stage(prep.llr.reshape(b * k, 128),
                           prep.valid.reshape(b * k))
    bp = jax.tree_util.tree_map(
        lambda a: a.reshape((b, k) + a.shape[1:]), bp_flat)
    with jax.named_scope("compact"):
        return jax.vmap(lambda pr, bb: finish_window(pr, bb, cfg))(prep, bp)


@functools.partial(jax.jit, static_argnames=("cfg",))
def decode_raw(raw: jnp.ndarray, cfg: DecoderConfig) -> WindowDecodeResult:
    """Jitted: batch of raw windows (B, raw_len) -> batched results (see
    decode_windows; frequency tables are jit constants from cfg)."""
    with jax.named_scope("preprocess"):
        c = preprocess(raw, cfg)
    return decode_windows(c, tuple(float(f) for f in cfg.freqs), cfg)


def raw_window_len(cfg: DecoderConfig) -> int:
    return _N * 2 if cfg.read_mode == 2 else _N


def unpack_candidate_index(cfg: DecoderConfig, flat_idx: int) -> tuple[int, int, int]:
    """Flat candidate index -> (freq_idx, pattern_idx, candidate_num)."""
    per_f = cfg.scan_depth * cfg.candidates_per_pattern
    fi, rem = divmod(int(flat_idx), per_f)
    pi, cn = divmod(rem, cfg.candidates_per_pattern)
    return fi, pi, cn
