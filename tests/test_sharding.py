"""Multi-device tests on the virtual 8-device CPU mesh (conftest.py)."""

import jax
import numpy as np
import pytest

from msk144cudecoder_tpu import constants as C
from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.config import DecoderConfig
from msk144cudecoder_tpu.ops import pipeline
from msk144cudecoder_tpu.ops.tables import padded_freqs
from msk144cudecoder_tpu.parallel import MeshDecoder, make_mesh, stream_to_windows
from msk144cudecoder_tpu.protocol import msg77

CFG = DecoderConfig(search_width=100.0, scan_depth=3, max_survivors=64)


@pytest.fixture(scope="module")
def audio():
    return G.synthesize_audio_int16(
        [("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=np.random.default_rng(5)
    )


def decoded_texts(res, n_windows):
    hashes = msg77.CallsignHashTable()
    texts = [set() for _ in range(n_windows)]
    found = np.asarray(res.found)
    bits = pipeline.unpack_message_bits(res.message_bits)
    for b in range(n_windows):
        for k in np.nonzero(found[b])[0]:
            ok, text = msg77.unpack77(bits[b][k].astype(np.int8), hashes)
            if ok:
                texts[b].add(text)
    return texts


class TestMesh:
    def test_make_mesh_shapes(self):
        m = make_mesh(2, 4)
        assert m.shape == {"time": 2, "freq": 4}
        with pytest.raises(ValueError):
            make_mesh(3, 3)

    def test_padded_freqs(self):
        f = padded_freqs(CFG.freqs, 4)  # 51 -> 52
        assert len(f) == 52
        assert f[-1] == pytest.approx(CFG.freqs[-1] + CFG.search_step)


class TestStreamToWindows:
    def test_overlap_framing(self):
        s = np.arange(C.WINDOW_LEN * 2, dtype=np.int16)
        w = stream_to_windows(s, 1)
        assert w.shape == (3, C.WINDOW_LEN)
        np.testing.assert_array_equal(w[1], s[C.HOP_LEN : C.HOP_LEN + C.WINDOW_LEN])


class TestMeshDecoder:
    def test_freq_sharded_decode_matches_single_device(self, audio):
        mesh = make_mesh(1, 8)
        md = MeshDecoder(CFG, mesh)
        raw = audio[None, :]
        res = md.decode(raw)
        texts = decoded_texts(res, 1)
        assert "CQ K1ABC FN42" in texts[0]

        # candidate indices must map back to real frequencies near 1500 Hz
        found = np.asarray(res.found[0])
        best = None
        for k in np.nonzero(found)[0]:
            fi, pi, _ = md.unpack_candidate_index(int(res.cand_index[0][k]))
            assert 0 <= fi < len(md.freqs)
            if pi == 0:
                best = md.freqs[fi]
        assert best is not None and abs(best - 1500.0) <= 2.0

    def test_time_and_freq_sharded(self, audio):
        mesh = make_mesh(2, 4)
        md = MeshDecoder(CFG, mesh)
        noise = (np.random.default_rng(0).normal(0, 1000, C.WINDOW_LEN)).astype(np.int16)
        raw = np.stack([audio, noise])
        res = md.decode(raw)
        texts = decoded_texts(res, 2)
        assert "CQ K1ABC FN42" in texts[0]
        assert texts[1] == set()

    def test_sharded_equals_unsharded_survivors(self, audio):
        """The union of per-shard survivors must contain every single-device
        survivor that decodes (freq sharding must not lose messages)."""
        mesh = make_mesh(1, 8)
        md = MeshDecoder(CFG, mesh)
        res_sh = md.decode(audio[None, :])
        res_1 = pipeline.decode_raw(audio[None, :], CFG)
        t_sh = decoded_texts(res_sh, 1)[0]
        t_1 = decoded_texts(res_1, 1)[0]
        assert t_1 <= t_sh
