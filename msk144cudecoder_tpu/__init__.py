"""msk144cudecoder_tpu — an MSK144 meteor-scatter stream decoder in JAX.

A from-scratch JAX/XLA framework with the capabilities of the CUDA
reference decoder (alexander-sholohov/msk144cudecoder): analytic-signal
conversion, wideband sync-pattern search, coherent multi-frame averaging,
batched softbit demodulation, LDPC(128,90) belief propagation, CRC-13, and
full 77-bit WSJT-X message unpacking — redesigned as batched array programs
(matmuls, static shapes, masked batching, mesh sharding) rather than ported.
It runs on an NVIDIA GPU, with one fused Pallas kernel for LDPC BP.
"""

__version__ = "0.1.0"
