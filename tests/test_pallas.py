"""The plain scan against the float64 golden model, the fused BP kernel
(ops/bp_kernel.py, Pallas interpreter here; compiled on a CUDA device by
chip_smoke.py) against the plain BP reference, and the shipping pipeline
end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msk144cudecoder_tpu import constants as C
from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig
from msk144cudecoder_tpu.ops import bp_kernel, ldpc, pipeline, scan


@pytest.fixture(scope="module")
def cdat_np():
    a = G.synthesize_audio_int16(
        [("CQ K1ABC FN42", 1500.0)], 6, snr_db=8.0, rng=np.random.default_rng(3)
    )
    return G.analytic_method2(G.rms_normalize_int16(a))


@pytest.fixture(scope="module")
def cdat(cdat_np):
    return jnp.asarray(cdat_np.astype(np.complex64))


FREQS = tuple(float(f) for f in np.arange(1450.0, 1551.0, 2.0))


@pytest.fixture(scope="module")
def golden_xb(cdat_np):
    """float64 lag fields |s_p(f, lag)| for every (freq, pattern)."""
    return [[G.scan_xb(cdat_np, f, p) for p in range(8)] for f in FREQS]


class TestPallasScan:
    @pytest.mark.parametrize("depth", [1, 4, 6, 8])
    @pytest.mark.parametrize("dec", [1, 2, 4])
    def test_matches_jnp_scan(self, cdat, golden_xb, depth, dec):
        """scan.scan (float32) against the float64 golden selection over the
        same dec x depth grid. Candidate equivalence, not bit-identity:
        near-tied slice maxima can swap ranks between float32 and float64
        (SURVEY §7 hard part 5); the per-cell xb value-sets must agree and
        most positions coincide."""
        pos, xb = scan.scan(cdat, FREQS, depth, dec=dec)
        p0, x0 = np.asarray(pos), np.asarray(xb)
        assert p0.shape == (len(FREQS), depth, 8)
        assert (p0 % dec == 0).all()
        same = 0
        for f in range(len(FREQS)):
            for p in range(depth):
                want = G.slice_candidates(golden_xb[f][p], dec)
                wp = [w[0] for w in want]
                wx = np.array([w[1] for w in want])
                np.testing.assert_allclose(np.sort(x0[f, p]), np.sort(wx),
                                           rtol=5e-3, atol=5e-3)
                assert len(set(p0[f, p]) & set(wp)) >= 5
                same += int((p0[f, p] == np.asarray(wp)).sum())
        assert same / p0.size > 0.85

    def test_decimated_select_semantics(self, cdat):
        """The coarse grid is the full field subsampled: each dec-grid
        candidate's xb equals the full field's value at that (even) lag, and
        each slice winner is the argmax over the slice's coarse lags."""
        freqs = FREQS
        G_ = scan.sync_correlation(cdat, freqs)
        xb = scan.pattern_metrics(G_, 4)
        for dec in (2, 4):
            pos, top = scan.select_candidates(xb, dec=dec)
            pos_n, top_n = np.asarray(pos), np.asarray(top)
            field = np.asarray(
                jnp.concatenate([xb, xb[:, : C.SCAN_PAD_LEN - C.WINDOW_LEN, :]],
                                axis=1))
            assert (pos_n % dec == 0).all()
            # spot-check: every reported xb is the field value at pos
            for f in (0, 17):
                for p in range(4):
                    for k in range(8):
                        lag = pos_n[f, p, k]
                        vals = {field[p, lag, f]}
                        if lag < C.SCAN_PAD_LEN - C.WINDOW_LEN:
                            vals.add(field[p, lag + C.WINDOW_LEN, f])
                        assert any(abs(v - top_n[f, p, k]) < 1e-3 * max(abs(v), 1)
                                   for v in vals)

    def test_nonmultiple_freq_count(self, cdat, golden_xb):
        freqs = FREQS[:37]
        pos, xb = scan.scan(cdat, freqs, 3)
        assert pos.shape == (37, 3, 8)
        x0 = np.asarray(xb)
        for f in (0, 18, 36):
            for p in range(3):
                want = np.sort([w[1] for w in G.slice_candidates(golden_xb[f][p])])
                np.testing.assert_allclose(np.sort(x0[f, p]), want,
                                           rtol=5e-3, atol=5e-3)


def _llr_batch(k=24, n_good=10, seed=5, amp=4.0):
    from msk144cudecoder_tpu.protocol import crc as crc_mod
    from msk144cudecoder_tpu.protocol import ldpc_tables as T

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_good):
        msg = rng.integers(0, 2, 77)
        cw = T.encode(np.concatenate([msg, (crc_mod.CRC_MATRIX @ msg) % 2]))
        rows.append((2.0 * cw - 1.0) * amp + rng.normal(0, 1.0, 128))
    for _ in range(k - n_good):
        rows.append(rng.normal(0, 2.0, 128))
    return jnp.asarray(np.stack(rows), jnp.float32)


def _assert_bp_equal(r0, r1):
    for f in ("found", "codeword", "iterations", "hard_errors"):
        np.testing.assert_array_equal(np.asarray(getattr(r0, f)),
                                      np.asarray(getattr(r1, f)), err_msg=f)


class TestPallasLDPC:
    def test_matches_jnp_bp_exactly(self):
        """Weak rows that need several BP iterations: the kernel's decisions
        (found, codeword, iteration, hard-error count) equal the plain
        reference's on every row."""
        llr = 2.0 * _llr_batch(k=64, n_good=64, seed=1, amp=1.6)
        valid = jnp.asarray(np.ones(llr.shape[0], bool))
        r0 = ldpc.bp_decode(llr, valid)
        r1 = bp_kernel.bp_decode(llr, valid, interpret=True)
        _assert_bp_equal(r0, r1)
        it = np.asarray(r1.iterations)[np.asarray(r1.found)]
        assert len(it) >= 30 and it.max() >= 5

    def test_validity_mask_blocks_decode(self):
        llr = _llr_batch(k=8, n_good=8, seed=7)
        valid = jnp.asarray(np.array([True, False] * 4))
        r = bp_kernel.bp_decode(llr, valid, interpret=True)
        found = np.asarray(r.found)
        assert found[0::2].all() and not found[1::2].any()

    def test_row_chunk_padding(self):
        """Row counts that are not a multiple of the kernel's row block pad
        up with invalid rows that must not perturb real rows."""
        k = bp_kernel.BLOCK_ROWS + 7
        llr = _llr_batch(k=k, n_good=10, seed=13)
        valid = jnp.asarray(np.ones(k, bool))
        r0 = ldpc.bp_decode(llr, valid)
        r1 = bp_kernel.bp_decode(llr, valid, interpret=True)
        assert np.asarray(r1.found).shape == (k,)
        _assert_bp_equal(r0, r1)

    def test_vmap_batching(self):
        llr = _llr_batch(k=16, n_good=6, seed=11)
        valid = jnp.asarray(np.ones(16, bool))
        r1 = bp_kernel.bp_decode(llr, valid, interpret=True)
        rv = jax.vmap(lambda l: bp_kernel.bp_decode(l, valid, interpret=True))(
            jnp.stack([llr, llr]))
        np.testing.assert_array_equal(np.asarray(rv.found[0]), np.asarray(rv.found[1]))
        np.testing.assert_array_equal(np.asarray(rv.found[0]), np.asarray(r1.found))
        np.testing.assert_array_equal(np.asarray(rv.codeword[0]), np.asarray(r1.codeword))

    @pytest.mark.parametrize("k,n_valid", [(1, 1), (5, 3), (31, 31), (33, 20),
                                           (70, 0)])
    def test_wrapper_shapes_and_invalid_rows(self, k, n_valid):
        """Any row count, including all-invalid batches: shapes and dtypes
        match the reference, invalid rows never decode."""
        llr = _llr_batch(k=k, n_good=k, seed=k)
        valid = jnp.asarray(np.arange(k) < n_valid)
        r0 = ldpc.bp_decode(llr, valid)
        r1 = bp_kernel.bp_decode(llr, valid, interpret=True)
        for a, b in zip(r0, r1):
            assert a.shape == b.shape and a.dtype == b.dtype
        _assert_bp_equal(r0, r1)
        assert not np.asarray(r1.found)[n_valid:].any()
        assert np.asarray(r1.found)[:n_valid].all()


class TestKernelChoice:
    """bp_stage picks the fused kernel when compiled for a CUDA device and
    the plain reference for every other platform — per lowering platform,
    with no option to select between them."""

    def test_cpu_lowering_runs_reference(self):
        llr = _llr_batch(k=40, n_good=10, seed=3)
        valid = jnp.asarray(np.ones(40, bool))
        f = jax.jit(pipeline.bp_stage)
        assert "triton" not in f.lower(llr, valid).as_text()
        _assert_bp_equal(f(llr, valid), ldpc.bp_decode(llr, valid))

    def test_cuda_lowering_runs_kernel(self):
        llr = _llr_batch(k=40, n_good=10, seed=3)
        valid = jnp.asarray(np.ones(40, bool))
        txt = jax.jit(pipeline.bp_stage).trace(llr, valid).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "triton" in txt and "ldpc_bp" in txt


@pytest.mark.gpu
def test_compiled_bp_kernel_matches_reference(cuda_device):
    """Compiled kernel vs the plain reference on the card (chip_smoke.py
    phase 3 runs the same comparison at 65,536 real rows)."""
    llr = jax.device_put(2.0 * _llr_batch(k=256, n_good=200, seed=1, amp=1.6),
                         cuda_device)
    valid = jax.device_put(jnp.ones(256, bool), cuda_device)
    _assert_bp_equal(jax.jit(ldpc.bp_decode)(llr, valid),
                     jax.jit(bp_kernel.bp_decode)(llr, valid))


def _decoded_texts(res, b=0):
    from msk144cudecoder_tpu.protocol import msg77

    h = msg77.CallsignHashTable()
    found = set()
    for k in np.nonzero(np.asarray(res.found[b]))[0]:
        ok, t = msg77.unpack77(
            pipeline.unpack_message_bits(res.message_bits[b][k]), h)
        if ok:
            found.add(t)
    return found


class TestPallasPipeline:
    def test_end_to_end_decode_matches(self):
        """The shipping path (prefilter on) and the full demod (prefilter
        off) find the same message."""
        a = G.synthesize_audio_int16(
            [("K1ABC W9XYZ EN37", 1496.0)], 6, snr_db=6.0, rng=np.random.default_rng(9))
        base = DecoderConfig(search_width=100.0, scan_depth=3, max_survivors=128)
        texts = {pre: _decoded_texts(pipeline.decode_raw(
            a[None, :], base.replace(survivor_prefilter=pre)))
            for pre in (None, 0)}
        assert texts[None] == texts[0] == {"K1ABC W9XYZ EN37"}

    def test_iq_mode_pallas(self):
        iq = G.synthesize_iq_int8(
            [("K1ABC W9XYZ EN37", 20.0)], 6, snr_db=10.0, rng=np.random.default_rng(6))
        cfg = DecoderConfig.create(read_mode=2, search_width=100.0, scan_depth=3,
                                   max_survivors=128)
        assert _decoded_texts(pipeline.decode_raw(iq[None, :], cfg)) == {
            "K1ABC W9XYZ EN37"}

    def test_analytic_method1_pallas(self):
        a = G.synthesize_audio_int16(
            [("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=np.random.default_rng(4))
        cfg = DecoderConfig(search_width=100.0, scan_depth=3, max_survivors=128,
                            analytic_method=1)
        assert _decoded_texts(pipeline.decode_raw(a[None, :], cfg)) == {
            "CQ K1ABC FN42"}


class TestBatchedDecodeRaw:
    def test_flat_batched_equals_per_window(self):
        """decode_raw runs BP once on the whole batch's survivors; results
        must equal the per-window decode_window_tables path element for
        element."""
        cfg = DecoderConfig(search_width=100.0, scan_depth=3,
                            max_survivors=128, survivor_prefilter=256)
        rng = np.random.default_rng(5)
        rows = [G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6,
                                         snr_db=4.0, rng=rng)]
        rows.append(rng.normal(0, 1000, (5184,)).astype(np.int16))
        raw = jnp.asarray(np.stack(rows))
        res_b = pipeline.decode_raw(raw, cfg)
        freqs = tuple(float(f) for f in cfg.freqs)
        res_w = jax.vmap(lambda w: pipeline.decode_window_tables(
            w, freqs, cfg))(pipeline.preprocess(raw, cfg))
        assert np.asarray(res_b.found).any()
        for f in res_b._fields:
            a, b = np.asarray(getattr(res_b, f)), np.asarray(getattr(res_w, f))
            np.testing.assert_array_equal(a, b, err_msg=f)
