"""Fused LDPC(128,90) belief propagation for CUDA devices (Pallas, Triton
route).

Same semantics as the plain reference ops/ldpc.bp_decode (the reference
decoder's ldpc_kernel.cuh:100-248): check before each message update,
iteration 0 = raw hard decision, results frozen at a row's first success,
the piecewise-linear platanh, log-domain leave-one-out products.

The reference runs one CUDA block per survivor, one thread per codeword
bit, with every message in shared memory and registers for all ten
iterations. Here one program decodes a block of BLOCK_ROWS survivors,
and every per-row array stays on chip for the whole loop, so nothing
but the LLRs in and the results out touches device memory. The plain XLA
form instead writes every (rows, 418) intermediate of its ~12 one-hot
matmuls per iteration to device memory.

Layout is bit-major. Every codeword bit sits in exactly three checks
(protocol/ldpc_tables.MN), so the check->bit messages are one (R, 4, 128)
array, tov[:, k, b] = the message from b's k-th check (slot 3 is padding,
held at zero: Triton blocks are powers of two). Then
  zn    = llr + sum_k tov[:, k]                  elementwise
  toc   = zn[:, None] - tov                      elementwise
and the only cross-bit movement is per-check: the group sums of log2|tanh|
and of the negative-sign count over a check's bits, and the broadcast of
each check's sums back to its bits. Those are products with one constant
0/1 incidence matrix G (512, 64), G[128 k + b, r] = 1 iff check r is b's
k-th check: group sum = x.reshape(R, 512) @ G, broadcast = S @ G^T. All
products run on the tensor cores in bfloat16 with float32 accumulation:
0/1 values and counts <= 11 are exact, and float32 operands are split
exactly into three bfloat16 parts by truncation (_split3), so a broadcast
reproduces its float32 input bit for bit and a group sum differs from the
plain reference only in the order it adds <= 11 terms.
The parity and CRC-13 gates are one product with a (128, 64) matrix whose
columns 0..37 are the check incidence and 38..50 the CRC: payload bits'
CRC rows plus the bit that carries that CRC bit, so every column of a valid
codeword sums even.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .. import constants as C
from ..protocol import crc as crc_mod
from ..protocol import ldpc_tables as T
from .ldpc import _LOG_FLOOR, BPResult, platanh

BLOCK_ROWS = 16  # survivors per program
NUM_WARPS = 8
_COLS = 64  # check columns, padded to a power of two (38 checks + 13 CRC)


@functools.lru_cache(maxsize=None)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(G (512, 64) bit-slot -> check incidence, row 128 k + b; CHK
    (128, 64) parity + CRC gate matrix), both 0/1 float32."""
    G = np.zeros((4, 128, _COLS), np.float32)
    for b in range(128):
        for k in range(3):
            G[k, b, T.MN[b, k, 0]] = 1.0
    CHK = np.zeros((128, _COLS), np.float32)
    CHK[:, : T.N_CHECKS] = G[:3].sum(axis=0)[:, : T.N_CHECKS]
    crc_m = crc_mod.CRC_MATRIX.T  # (77, 13)
    n_crc = crc_m.shape[1]
    CHK[:77, T.N_CHECKS : T.N_CHECKS + n_crc] = crc_m
    for j in range(n_crc):
        CHK[77 + j, T.N_CHECKS + j] = 1.0
    return G.reshape(4 * 128, _COLS), CHK


def _split3(x):
    """float32 -> three bfloat16 parts with x == h + m + l exactly: each part
    is the leading 8 significant bits of what remains (bit masks, which no
    compiler folds away, unlike a bfloat16 round trip)."""
    top = jnp.int32(-65536)  # sign, exponent and 7 mantissa bits

    def trunc(v):
        return jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(v, jnp.int32) & top, jnp.float32)

    h = trunc(x)
    r = x - h
    m = trunc(r)
    return (h.astype(jnp.bfloat16), m.astype(jnp.bfloat16),
            (r - m).astype(jnp.bfloat16))


def _dot3(x, g, trans_b=False):
    """x @ g (or g^T) for float32 x and 0/1 bfloat16 g on the tensor cores."""
    out = None
    for part in _split3(x):
        d = pl.dot(part, g, trans_b=trans_b)
        out = d if out is None else out + d
    return out


def _bp_kernel(llr_ref, valid_ref, g_ref, chk_ref,
               found_ref, cw_ref, iters_ref, nerr_ref, *, max_iters: int):
    llr = llr_ref[...]  # (R, 128) float32
    valid = valid_ref[...] != 0  # (R,)
    hard_in = llr > 0.0
    rows = llr.shape[0]
    slot_ok = jax.lax.broadcasted_iota(jnp.int32, (1, 4, 1), 1) < 3

    def body(carry):
        it, tov, found, cw_s, iter_s, nerr_s = carry
        zn = llr + jnp.sum(tov, axis=1)
        cw = zn > 0.0
        x = pl.dot(cw.astype(jnp.bfloat16), chk_ref[...])  # (R, 64) counts
        odd = jnp.max(x - 2.0 * jnp.floor(x * 0.5), axis=1)
        nerr = jnp.sum((cw != hard_in).astype(jnp.int32), axis=1)
        ok = (odd == 0.0) & (nerr < C.MAX_HARD_ERRORS) & valid
        newly = ok & ~found
        cw_s = jnp.where(newly[:, None], cw.astype(jnp.int32), cw_s)
        iter_s = jnp.where(newly, it, iter_s)
        nerr_s = jnp.where(newly, nerr, nerr_s)
        found = found | newly

        t = jnp.tanh(-0.5 * (zn[:, None, :] - tov))  # (R, 4, 128)
        lt = jnp.log2(jnp.maximum(jnp.abs(t), _LOG_FLOOR))
        neg = t < 0.0
        g = g_ref[...]
        s_e = _dot3(_dot3(lt.reshape(rows, 512), g), g, trans_b=True)
        nc = pl.dot(neg.reshape(rows, 512).astype(jnp.bfloat16), g)
        nc_e = pl.dot(nc.astype(jnp.bfloat16), g, trans_b=True)  # <= 11
        others = nc_e.reshape(rows, 4, 128) - neg.astype(jnp.float32)
        par = others - 2.0 * jnp.floor(others * 0.5)
        loo = (1.0 - 2.0 * par) * jnp.exp2(s_e.reshape(rows, 4, 128) - lt)
        tov = jnp.where(slot_ok, 2.0 * platanh(-loo), 0.0)
        return (it + 1, tov, found, cw_s, iter_s, nerr_s)

    def cond(carry):
        it, found = carry[0], carry[2]
        pending = jnp.max((valid & ~found).astype(jnp.int32))
        return (it < max_iters) & (pending > 0)

    zi = jnp.zeros((rows,), jnp.int32)
    init = (jnp.int32(0), jnp.zeros((rows, 4, 128), jnp.float32),
            jnp.zeros((rows,), jnp.bool_), jnp.zeros((rows, 128), jnp.int32),
            zi, zi)
    _, _, found, cw_s, iter_s, nerr_s = jax.lax.while_loop(cond, body, init)
    found_ref[...] = found.astype(jnp.int32)
    cw_ref[...] = cw_s
    iters_ref[...] = iter_s
    nerr_ref[...] = nerr_s


def bp_decode(llr: jnp.ndarray, valid: jnp.ndarray,
              max_iters: int = C.NUM_BP_ITERATIONS,
              interpret: bool = False) -> BPResult:
    """Batched BP decode, llr (K, 128) float32, valid (K,) bool, as
    ldpc.bp_decode. Any K: rows are padded to a multiple of BLOCK_ROWS with
    invalid rows, which never decode, and sliced off. `interpret` runs the
    kernel in the Pallas interpreter (CPU tests); a compiled call needs a
    CUDA device."""
    K = llr.shape[0]
    kp = -(-max(K, 1) // BLOCK_ROWS) * BLOCK_ROWS
    llr_p = jnp.zeros((kp, 128), jnp.float32).at[:K].set(
        llr.astype(jnp.float32))
    valid_p = jnp.zeros((kp,), jnp.int32).at[:K].set(valid.astype(jnp.int32))
    G, CHK = _tables()
    R = BLOCK_ROWS
    row = lambda i: (i, 0)
    vec = pl.BlockSpec((R,), lambda i: (i,))
    found, cw, iters, nerr = pl.pallas_call(
        functools.partial(_bp_kernel, max_iters=max_iters),
        grid=(kp // R,),
        in_specs=[
            pl.BlockSpec((R, 128), row),
            vec,
            pl.BlockSpec(G.shape, lambda i: (0, 0)),
            pl.BlockSpec(CHK.shape, lambda i: (0, 0)),
        ],
        out_specs=[vec, pl.BlockSpec((R, 128), row), vec, vec],
        out_shape=[
            jax.ShapeDtypeStruct((kp,), jnp.int32),
            jax.ShapeDtypeStruct((kp, 128), jnp.int32),
            jax.ShapeDtypeStruct((kp,), jnp.int32),
            jax.ShapeDtypeStruct((kp,), jnp.int32),
        ],
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="ldpc_bp",
    )(llr_p, valid_p, jnp.asarray(G, jnp.bfloat16),
      jnp.asarray(CHK, jnp.bfloat16))
    return BPResult(found[:K] != 0, cw[:K].astype(jnp.int8), iters[:K],
                    nerr[:K])
