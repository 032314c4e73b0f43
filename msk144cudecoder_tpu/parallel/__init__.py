"""Multi-device sharding: frequency-channel + time-block parallel decode.

The reference is single-process single-GPU (SURVEY.md §2); its embarrassing
grid parallelism over frequency channels (one CUDA block per channel,
/root/reference/src/msk_context.cuh:102-123) becomes a sharded frequency axis
on a device mesh, and the streaming window axis becomes a sharded
data-parallel time axis.
"""

from .sharding import MeshDecoder, make_mesh, stream_to_windows

__all__ = ["MeshDecoder", "make_mesh", "stream_to_windows"]
