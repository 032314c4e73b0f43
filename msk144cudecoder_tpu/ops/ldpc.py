"""Masked batched LDPC(128,90) belief propagation + CRC gate.

Plain-XLA redesign of the reference BP kernel
(/root/reference/src/ldpc_kernel.cuh:100-248), and the reference that the
fused CUDA-device kernel (ops/bp_kernel.py) is checked against. The
reference sizes its grid dynamically from a stream-compacted survivor count
(src/index_kernel.cuh); XLA wants static shapes, so we decode a fixed top-K
survivor batch with a validity mask.

Faithful semantics per iteration (checked before message updates, iteration 0
= raw hard decision, like the reference):
  zn = llr + sum_k tov ; cw = zn > 0
  parity over all 38 checks; if clean, CRC-13 gate (as a GF(2) mat-vec — the
  CRC is linear, see protocol/crc.py) and hard-error count < 18
  bit->check:  toc[e] = zn[bit(e)] - tov[bit(e), slot(e)]     (edge e = 11r+j)
  check->bit:  leave-one-out product of tanh(-toc/2) along each check row,
               then tov = 2 * platanh(-prod)
platanh is the reference's 5-segment piecewise-linear atanh.

Layout: every array is flat — edges as (K, 418), the 11 slots of a check
consecutive. Check->bit messages (tov) live natively in edge layout (toc =
zn_e - tov_e is elementwise); the leave-one-out runs in the LOG DOMAIN
(_loo_log_domain: per-check group sums of log2|tanh| and their broadcast
back as one-hot matmuls, exp2 of sum-minus-own, negative-count parity for
the sign). The bit->edge copy of zn is plain indexing; the sums over a
bit's or a check's edges are matmuls with constant 0/1 matrices.

A decoded candidate's result freezes at its first success (early-exit
equivalent); BP keeps running for the rest of the batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..protocol import crc as crc_mod
from ..protocol import ldpc_tables as T

# Every matmul here multiplies a 0/1 matrix by bf16-valued operands (the
# split3_xla parts, 0/1 bits, small integer counts), so each product is
# exact at Precision.HIGH: TF32 (10 explicit mantissa bits) on a CUDA
# device, full float32 on the CPU; the float32 accumulator then adds the
# few nonzero terms. A full-mantissa
# float32 operand would be rounded to TF32 on a CUDA device, so the one
# full-mantissa selection (zn -> edges) is plain indexing instead.
_EXACT_SEL = jax.lax.Precision.HIGH

_NE = T.N_CHECKS * T.MAX_ROW_DEGREE  # 418 edges (padded to 11 per check)


@functools.lru_cache(maxsize=None)
def _tables() -> dict:
    """Edge-incidence tables (flat layouts, edge e = 11r + j).

      EDGE_BIT  (418,) int32  bit of each edge (padded edges: bit 0, masked
                              by edge_valid downstream)
      SEL_SUM   (418, 128)    sum of a bit's <= 3 edges (0/1)
      COUNT_M   (128, 38)     bit-in-check incidence (parity row sums)
    """
    NM = T.NM  # (38, 11) bit index per (check, slot), -1 pad
    MN = T.MN  # (128, 3) -> (check, slot)
    edge_valid = NM >= 0
    SEL_SUM = np.zeros((_NE, 128), dtype=np.float32)
    COUNT_M = np.zeros((128, T.N_CHECKS), dtype=np.float32)
    for r in range(T.N_CHECKS):
        for j in range(T.MAX_ROW_DEGREE):
            b = NM[r, j]
            if b < 0:
                continue
            e = r * T.MAX_ROW_DEGREE + j
            COUNT_M[b, r] = 1.0
            assert any(MN[b, k, 0] == r and MN[b, k, 1] == j
                       for k in range(3))
            SEL_SUM[e, b] = 1.0
    # group-sum / group-broadcast one-hots for the log-domain leave-one-out
    # (GRP columns 0..37 sum a check row's edges; BACK fans a per-check
    # value back to its edges; padded edges/checks select nothing)
    GRP = np.zeros((_NE, 128), dtype=np.float32)
    BACK = np.zeros((128, _NE), dtype=np.float32)
    for e in range(_NE):
        r = e // T.MAX_ROW_DEGREE
        GRP[e, r] = 1.0
        BACK[r, e] = 1.0
    return {
        "edge_valid_f": edge_valid.astype(np.float32).reshape(_NE),
        "EDGE_BIT": np.maximum(NM, 0).reshape(_NE).astype(np.int32),
        "SEL_SUM": SEL_SUM,
        "GRP": GRP,
        "BACK": BACK,
        "COUNT_M": COUNT_M,
        "CRC_M": crc_mod.CRC_MATRIX.T.astype(np.float32),  # (77, 13)
    }


def split3_xla(x):
    """Exact 3-way bf16-valued f32 split (x == h + m + l, 3x8 mantissa bits)
    built on lax.reduce_precision — the astype(bf16).astype(f32) idiom is
    folded to identity under --xla_allow_excess_precision, which would
    silently zero the low parts."""
    h = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=7)
    r1 = x - h
    m = jax.lax.reduce_precision(r1, exponent_bits=8, mantissa_bits=7)
    return h, m, r1 - m


def platanh(x: jnp.ndarray) -> jnp.ndarray:
    """Piecewise-linear atanh approximation (ldpc_kernel.cuh:65-93)."""
    z = jnp.abs(x)
    s = jnp.where(x < 0.0, -1.0, 1.0)
    return jnp.where(
        z <= 0.664,
        x / 0.83,
        s
        * jnp.where(
            z <= 0.9217,
            (z - 0.4064) / 0.322,
            jnp.where(
                z <= 0.9951,
                (z - 0.8378) / 0.0524,
                jnp.where(z <= 0.9998, (z - 0.9914) / 0.0012, 7.0),
            ),
        ),
    )


_LOG_FLOOR = 2.0 ** -80  # |tanh| clamp before log2: a zero message (toc==0)
# floors at -80, so excluding it via S - log2|own| recovers the product of
# the OTHER edges exactly in spirit (the reference's serial exclusion,
# ldpc_kernel.cuh:232-246), and any group with a tiny member underflows
# exp2 to 0 gracefully (same sign behavior as the product form).


def _loo_log_domain(t, GRP, BACK, edge_valid_f):
    """Leave-one-out products of the 11-slot check groups via log-domain
    group sums: |loo| = exp2(sum_group log2|t| - log2|t_own|), sign = parity
    of the group's negative count excluding own: 4 one-hot matmuls (exact
    products: split-3 data side, 0/1 one-hots) + log2/exp2 instead of a
    serial product per edge. Values differ from the product form by log/exp
    rounding (~1e-6 relative) — far below platanh's own approximation."""
    lt = jnp.log2(jnp.maximum(jnp.abs(t), _LOG_FLOOR))
    h, m, l = split3_xla(lt)
    S = jnp.zeros(t.shape[:-1] + (128,), jnp.float32)
    for part in (h, m, l):
        S = S + jnp.matmul(part, GRP, precision=_EXACT_SEL)
    sh, sm, sl = split3_xla(S)
    S_e = jnp.zeros_like(t)
    for part in (sh, sm, sl):
        S_e = S_e + jnp.matmul(part, BACK, precision=_EXACT_SEL)
    mag = jnp.exp2(S_e - lt)
    neg = ((t < 0.0) & (edge_valid_f != 0.0)).astype(jnp.float32)
    negc = jnp.matmul(neg, GRP, precision=_EXACT_SEL)  # (K, 128) counts
    negc_e = jnp.matmul(negc, BACK, precision=_EXACT_SEL)
    others = negc_e - neg
    odd = others - 2.0 * jnp.floor(others * 0.5)
    return (1.0 - 2.0 * odd) * mag


def bit_to_edges(zn: jnp.ndarray) -> jnp.ndarray:
    """(K, 128) per-bit values -> (K, 418) per-edge copies (padded edges
    read bit 0; callers mask them with edge_valid)."""
    return zn[:, jnp.asarray(_tables()["EDGE_BIT"])]


class BPResult(NamedTuple):
    found: jnp.ndarray  # (K,) bool
    codeword: jnp.ndarray  # (K, 128) int8
    iterations: jnp.ndarray  # (K,) int32
    hard_errors: jnp.ndarray  # (K,) int32


def bp_decode(llr: jnp.ndarray, valid: jnp.ndarray, max_iters: int = C.NUM_BP_ITERATIONS) -> BPResult:
    """Batched BP decode. llr: (K, 128) float32; valid: (K,) bool mask."""
    tbl = _tables()
    edge_valid_f = jnp.asarray(tbl["edge_valid_f"])  # (418,) {0,1}
    SEL_SUM = jnp.asarray(tbl["SEL_SUM"])  # (418, 128)
    GRP = jnp.asarray(tbl["GRP"])  # (418, 128)
    BACK = jnp.asarray(tbl["BACK"])  # (128, 418)
    COUNT_M = jnp.asarray(tbl["COUNT_M"])  # (128, 38)
    CRC_M = jnp.asarray(tbl["CRC_M"])

    K = llr.shape[0]
    hard_in = llr > 0.0

    def check_stage(zn):
        cw = zn > 0.0
        cw_i = cw.astype(jnp.float32)
        row_sum = jnp.matmul(cw_i, COUNT_M, precision=_EXACT_SEL)  # (K, 38)
        row_par = row_sum - 2.0 * jnp.floor(row_sum * 0.5)
        ncheck = row_par.sum(axis=-1)  # (K,)
        crc_bits = jnp.matmul(cw_i[:, :77], CRC_M, precision=_EXACT_SEL)
        crc_bits = crc_bits - 2.0 * jnp.floor(crc_bits * 0.5)
        crc_ok = jnp.all(crc_bits == cw_i[:, 77:90], axis=-1)
        nerr = jnp.sum(cw != hard_in, axis=-1).astype(jnp.int32)
        ok = (ncheck == 0.0) & crc_ok & (nerr < C.MAX_HARD_ERRORS) & valid
        return cw, ok, nerr

    def body(it, state):
        tov_e, found, cw_s, iter_s, nerr_s = state  # tov_e (K, 418) edges
        # per-bit sum of the <=3 incident check messages via one summing
        # matmul per bf16 split part: each part's products are exact
        # (bf16-valued f32 x 0/1) and the f32 accumulator adds the <=3
        # nonzero terms.
        th, tm, tl = split3_xla(tov_e)
        zn = llr
        for part in (th, tm, tl):
            zn = zn + jnp.matmul(part, SEL_SUM, precision=_EXACT_SEL)
        cw, ok, nerr = check_stage(zn)
        newly = ok & (~found)
        cw_s = jnp.where(newly[:, None], cw.astype(jnp.int8), cw_s)
        iter_s = jnp.where(newly, it, iter_s)
        nerr_s = jnp.where(newly, nerr, nerr_s)
        found = found | newly

        # bit -> check: plain indexing (exact); tov is already per-edge
        zn_e = bit_to_edges(zn)  # (K, 418)
        toc = zn_e - tov_e
        t = jnp.where(edge_valid_f != 0.0, jnp.tanh(-0.5 * toc), 1.0)
        loo = _loo_log_domain(t, GRP, BACK, edge_valid_f)
        # check -> bit messages stay in edge layout (padded edges zeroed)
        tov_e = jnp.where(edge_valid_f != 0.0, 2.0 * platanh(-loo), 0.0)
        return tov_e, found, cw_s, iter_s, nerr_s

    init = (
        jnp.zeros((K, _NE), jnp.float32),
        jnp.zeros((K,), bool),
        jnp.zeros((K, 128), jnp.int8),
        jnp.zeros((K,), jnp.int32),
        jnp.zeros((K,), jnp.int32),
    )
    _, found, cw_s, iter_s, nerr_s = jax.lax.fori_loop(0, max_iters, body, init)
    return BPResult(found, cw_s, iter_s, nerr_s)
