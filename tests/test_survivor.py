"""xb-prefilter + survivor-only demod (softbits.demod_survivors).

Validates the per-survivor frame gather against the table-mixed full demod
(bit-exact: same products, same summation order), and end-to-end decode
parity between the prefiltered and full pipelines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig
from msk144cudecoder_tpu.ops import ldpc, pipeline, scan, softbits

CFG = DecoderConfig(search_width=100.0, scan_depth=6, nbadsync_threshold=3,
                    max_survivors=128)
FREQS = tuple(float(f) for f in CFG.freqs)


@pytest.fixture(scope="module")
def window():
    a = G.synthesize_audio_int16(
        [("CQ K1ABC FN42", 1505.0)], 6, snr_db=6.0,
        rng=np.random.default_rng(7))
    raw = jnp.asarray(a[None, :])
    return pipeline.preprocess(raw, CFG)[0]


@pytest.fixture(scope="module")
def candidates(window):
    pos, xb = scan.scan(window, FREQS, CFG.scan_depth)
    nc = pos.shape[0] * pos.shape[1] * pos.shape[2]
    xb_f = np.asarray(xb).reshape(nc)
    pre_idx = jnp.asarray(np.argsort(-xb_f)[:256].astype(np.int32))
    per_f = pos.shape[1] * pos.shape[2]
    return (pos, pre_idx, pre_idx // per_f,
            (pre_idx % per_f) // pos.shape[2], pos.reshape(nc)[pre_idx])


class TestGammaMath:
    def test_ref_matches_full_demod(self, window, candidates):
        """The survivor demod gathers each frame straight from the window
        and the mix table; it equals the full demod's softbits and
        nbadsync bit for bit."""
        pos, pre_idx, f_idx, p_idx, pos_s = candidates
        nc = pos.shape[0] * pos.shape[1] * pos.shape[2]
        sb_all, nbad_all = softbits.demod_candidates(
            window, FREQS, CFG.scan_depth, pos)
        sb_g = np.asarray(sb_all.reshape(nc, 128))[np.asarray(pre_idx)]
        nbad_g = np.asarray(nbad_all.reshape(nc))[np.asarray(pre_idx)]

        sb_r, nbad_r = softbits.demod_survivors(
            window, FREQS, pos_s, f_idx, p_idx)
        np.testing.assert_array_equal(np.asarray(nbad_r), nbad_g)
        np.testing.assert_array_equal(np.asarray(sb_r), sb_g)

    def test_survivor_table_fetch_exact(self, window):
        """The per-survivor mix-table fetch is plain indexing: on
        full-mantissa float32 tables it equals numpy indexing bit for bit
        (a matmul-based fetch rounds to TF32 on a CUDA device)."""
        rng = np.random.default_rng(3)
        F = len(FREQS)
        pos_s = jnp.asarray(rng.integers(0, 5184, 64).astype(np.int32))
        f_idx = jnp.asarray(rng.integers(0, F, 64).astype(np.int32))
        p_idx = jnp.zeros(64, jnp.int32)  # pattern 0: frame 0 alone
        ones = jnp.ones_like(window)
        got = np.asarray(jax.jit(softbits.survivor_frames, static_argnums=1)(
            ones, FREQS, pos_s, f_idx, p_idx))
        W = np.asarray(softbits._mix_table(FREQS))
        t = (np.asarray(pos_s)[:, None] + np.arange(864)) % 5184
        np.testing.assert_array_equal(got, W[np.asarray(f_idx)[:, None], t])

    def test_tiered_terms_match_flat(self, window, candidates):
        """Every averaging pattern (incl. the gap patterns 6 and 7): the
        survivor frames equal the pattern-averaged full-grid frames bit for
        bit."""
        pos, _, _, _, _ = candidates
        za = softbits.pattern_average(softbits.mix_all(window, FREQS), 8)
        for p in (0, 2, 5, 6, 7):
            pos8 = jnp.tile(pos[:, :1, :], (1, 8, 1))
            frames = np.asarray(softbits.gather_frames(za, pos8))
            fi = np.arange(0, len(FREQS), 3)
            got = softbits.survivor_frames(
                window, FREQS, pos8[fi, p, 0], jnp.asarray(fi, jnp.int32),
                jnp.full(len(fi), p, jnp.int32))
            np.testing.assert_array_equal(np.asarray(got), frames[fi, p, 0])

    def test_wrap_positions(self, window):
        """Candidates whose frames wrap the window boundary still match the
        table-mixed demod."""
        F = len(FREQS)
        pos_s = jnp.asarray(np.tile([5000, 5183, 4321, 3500], 32).astype(np.int32))
        f_idx = jnp.asarray((np.arange(128) * 7 % F).astype(np.int32))
        p_idx = jnp.asarray((np.arange(128) % 8).astype(np.int32))
        pos = jnp.zeros((F, 8, 1), jnp.int32)
        pos = pos.at[f_idx, p_idx, 0].set(pos_s)  # scatter for golden gather
        sb_all, nbad_all = softbits.demod_candidates(window, FREQS, 8, pos)
        sb_g = np.asarray(sb_all)[np.asarray(f_idx), np.asarray(p_idx), 0]
        nbad_g = np.asarray(nbad_all)[np.asarray(f_idx), np.asarray(p_idx), 0]

        sb_r, nbad_r = softbits.demod_survivors(
            window, FREQS, pos_s, f_idx, p_idx)
        np.testing.assert_array_equal(np.asarray(nbad_r), nbad_g)
        np.testing.assert_array_equal(np.asarray(sb_r), sb_g)


def test_ldpc_edge_selection_exact():
    """BP's bit->edge copy of zn is plain indexing: bit-exact on
    full-mantissa float32 (a one-hot matmul at Precision.HIGH rounds to
    TF32 on a CUDA device)."""
    from msk144cudecoder_tpu.protocol import ldpc_tables as T

    rng = np.random.default_rng(0)
    zn = (rng.standard_normal((16, 128)) * np.pi).astype(np.float32)
    got = np.asarray(jax.jit(ldpc.bit_to_edges)(jnp.asarray(zn)))
    nm = T.NM.reshape(-1)
    np.testing.assert_array_equal(got[:, nm >= 0], zn[:, nm[nm >= 0]])


class TestPrefilterPipeline:
    @staticmethod
    def _decode_summary(res, cfg):
        """Per-message (best num_avg, best nbadsync) — exactly what the
        output line depends on after ResultFilter dedup (the per-cell
        prefilter cap may drop redundant duplicate-lag decodes of the same
        message within one (freq, pattern) cell, so raw candidate sets are
        not comparable across paths)."""
        from msk144cudecoder_tpu import constants as C

        found = np.asarray(res.found)
        best = {}
        for bits, cand, nbad in zip(pipeline.unpack_message_bits(np.asarray(res.message_bits)[found]),
                                    np.asarray(res.cand_index)[found],
                                    np.asarray(res.nbadsync)[found]):
            _, p_idx, _ = pipeline.unpack_candidate_index(cfg, int(cand))
            key = (int(C.PATTERN_NUM_AVG[p_idx]), int(nbad))
            t = tuple(bits)
            best[t] = min(best.get(t, key), key)
        return best

    def test_decode_parity_with_full_path(self, window):
        # max_survivors large enough that the full path does not truncate
        # its survivor set (a truncated batch under-reports low-num_avg
        # decodes and makes the comparison depend on batch composition)
        cfg_full = CFG.replace(survivor_prefilter=0, max_survivors=512)
        cfg_pre = CFG.replace(survivor_prefilter=512, max_survivors=512)
        full = jax.jit(lambda w: pipeline.decode_window_tables(
            w, FREQS, cfg_full))(window)
        pre = jax.jit(lambda w: pipeline.decode_window_tables(
            w, FREQS, cfg_pre))(window)
        sum_full = self._decode_summary(full, cfg_full)
        sum_pre = self._decode_summary(pre, cfg_pre)
        assert sum_full == sum_pre and len(sum_full) == 1

    def test_noise_only_no_decodes(self):
        rng = np.random.default_rng(11)
        raw = jnp.asarray(
            rng.normal(0, 1000, (1, 5184)).astype(np.int16))
        w = pipeline.preprocess(raw, CFG)[0]
        pre = jax.jit(lambda x: pipeline.decode_window_tables(
            x, FREQS, CFG.replace(survivor_prefilter=256)))(w)
        assert not np.asarray(pre.found).any()

    def test_resolve_prefilter(self):
        cfg = CFG
        # auto: 2x max_survivors
        assert pipeline.resolve_prefilter(cfg, 24048) == 2 * cfg.max_survivors
        # explicit values are taken as given; >= nc or 0 disables
        assert pipeline.resolve_prefilter(
            cfg.replace(survivor_prefilter=100), 24048) == 100
        assert pipeline.resolve_prefilter(
            cfg.replace(survivor_prefilter=30000), 24048) == 0
        assert pipeline.resolve_prefilter(
            cfg.replace(survivor_prefilter=0), 24048) == 0
        # auto larger than the candidate grid: full demod
        assert pipeline.resolve_prefilter(cfg, 200) == 0

    @pytest.mark.parametrize("backend", ["cpu", "gpu", "cuda", "rocm"])
    def test_prefilter_default_same_on_every_backend(self, backend,
                                                     monkeypatch):
        """The auto rule is 2x max_survivors whatever the backend (it once
        switched the prefilter off away from one platform)."""
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        for k in (128, 256, 512):
            cfg = CFG.replace(max_survivors=k)
            assert pipeline.resolve_prefilter(cfg, 24048) == 2 * k
