"""shard_map decode over a (time, freq) device mesh.

Axes:
  "time"  — data parallel over streaming windows (the reference's while-loop
            iterations, main.cu:261); windows are independent after host-side
            50%-overlap framing, so this axis needs no communication.
  "freq"  — the reference's CUDA grid-x (one block per frequency channel,
            msk_context.cuh:102-123) becomes a sharded table axis: every
            device holds only its slice of the B/E/chi/W frequency tables
            and finds its own top-K survivors. Survivor lists concatenate
            across shards on output (the all-gather happens implicitly in
            the out_specs), so no device ever sees another's frequency slice.

The input window is replicated across "freq" (5184 complex64 = 40 KB — cheap)
and sharded across "time". Candidate indices are globalized with the shard's
frequency offset so host post-processing is shard-agnostic.

Scaling notes: per-device work is O(F_local); the only traffic between
devices is the window broadcast + (K_local * n_freq) survivor gather per
window. Every card of a host reaches every other at the same rate (NVLink,
all to all), so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..config import DecoderConfig
from ..ops import pipeline
from ..ops.tables import FreqTables, build_freq_tables, padded_freqs


def make_mesh(n_time: int = 1, n_freq: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (time, freq) mesh. Defaults: all devices on the freq axis."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_freq is None:
        n_freq = len(devices) // n_time
    if n_time * n_freq != len(devices):
        raise ValueError(f"mesh {n_time}x{n_freq} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(n_time, n_freq)
    return Mesh(arr, axis_names=("time", "freq"))


def stream_to_windows(samples: np.ndarray, read_mode: int = 1) -> np.ndarray:
    """Host-side overlap-save framing of a contiguous stream segment into the
    (B, window) batch the sharded decoder consumes: windows advance by 50%
    (HOP_LEN), mirroring the streaming loop's slide (main.cu:283-294)."""
    per = 2 if read_mode == 2 else 1
    n_full, n_hop = C.WINDOW_LEN * per, C.HOP_LEN * per
    n_win = (len(samples) - n_full) // n_hop + 1
    if n_win < 1:
        raise ValueError("stream segment shorter than one window")
    idx = np.arange(n_win)[:, None] * n_hop + np.arange(n_full)[None, :]
    return np.ascontiguousarray(samples[idx])


class MeshDecoder:
    """Sharded decode of a window batch over a (time, freq) mesh.

    Frequency tables are built once for the padded grid, device_put with their
    NamedSharding (each device receives only its slice), and closed over by a
    cached jit of the shard_map'd pipeline.
    """

    def __init__(self, cfg: DecoderConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        n_freq = mesh.shape["freq"]
        self.freqs = padded_freqs(cfg.freqs, n_freq)
        self.local_f = len(self.freqs) // n_freq

        tbl = build_freq_tables(self.freqs)
        self._tbl_specs = FreqTables(
            B=P(None, "freq"), E=P(None, "freq"), chi=P(None, "freq"), W=P("freq", None)
        )
        self._tbl = FreqTables(*(
            jax.device_put(a, NamedSharding(mesh, s))
            for a, s in zip(tbl, self._tbl_specs)
        ))
        self._fn = self._build()

    def _build(self):
        cfg = self.cfg
        local_cand = self.local_f * cfg.scan_depth * cfg.candidates_per_pattern
        n_real = cfg.num_freqs  # grid channels beyond this are sharding pad
        local_f = self.local_f

        def local_step(raw_local: jnp.ndarray, tbl_local: FreqTables):
            c = pipeline.preprocess(raw_local, cfg)
            # mask pad channels (grid extended past the right boundary for
            # divisibility) out of survivor selection — they must not search
            # outside the requested width nor compete for survivor slots
            chan0 = jax.lax.axis_index("freq").astype(jnp.int32) * local_f
            chan_valid = chan0 + jnp.arange(local_f, dtype=jnp.int32) < n_real
            # the same batched formulation as the single-device decode_raw
            # (flat-batch BP across the local time batch) — sized to the
            # LOCAL frequency slice
            res = pipeline.decode_windows(c, tbl_local, cfg,
                                          chan_valid=chan_valid)
            offset = jax.lax.axis_index("freq").astype(jnp.int32) * local_cand
            res = res._replace(
                cand_index=res.cand_index + offset,
                num_survivors=jax.lax.psum(res.num_survivors, "freq"),
                # each shard truncates at its LOCAL top-K; the warning needs
                # the worst shard, not just the global sum (ADVICE r4)
                shard_survivors=jax.lax.pmax(res.shard_survivors, "freq"),
            )
            return res

        k_axes = pipeline.WindowDecodeResult(
            cand_index=P("time", "freq"),
            valid=P("time", "freq"),
            found=P("time", "freq"),
            message_bits=P("time", "freq", None),
            nbadsync=P("time", "freq"),
            xb=P("time", "freq"),
            pos=P("time", "freq"),
            ldpc_iterations=P("time", "freq"),
            hard_errors=P("time", "freq"),
            num_survivors=P("time"),
            shard_survivors=P("time"),
            block_power=P("time", None),
        )
        in_specs = (P("time", None), self._tbl_specs)
        mapped = jax.shard_map(
            local_step, mesh=self.mesh, in_specs=in_specs, out_specs=k_axes,
            check_vma=False,
        )
        return jax.jit(mapped)

    def decode(self, raw_windows: np.ndarray) -> pipeline.WindowDecodeResult:
        """raw_windows: (B, raw_len), B divisible by the time-axis size.
        Returns globally-indexed results; the survivor axis is the
        concatenation of each freq-shard's top-K (K*n_freq total)."""
        return self._fn(jnp.asarray(raw_windows), self._tbl)

    def unpack_candidate_index(self, flat_idx: int) -> tuple[int, int, int]:
        """Global flat candidate index -> (freq_idx, pattern_idx, cand_num)."""
        per_f = self.cfg.scan_depth * self.cfg.candidates_per_pattern
        fi, rem = divmod(int(flat_idx), per_f)
        pi, cn = divmod(rem, self.cfg.candidates_per_pattern)
        return fi, pi, cn
