"""Host runtime: streaming shell, SNR tracking, result filtering, metrics.

Counterpart of the reference's L1/L6 host layers
(/root/reference/src/main.cu, snr_tracker.cu, result_filter.cpp, metrics.cpp,
decode_softbits.cpp). The compute path stays in ops/; everything here is the
thin host shell around the jitted pipeline.
"""

from .snr import SNRTracker
from .result_filter import ResultFilter, ResultItem
from .metrics import SimpleTimer, ScopedMetric, metrics_enabled
from .decoder import StreamDecoder

__all__ = [
    "SNRTracker",
    "ResultFilter",
    "ResultItem",
    "SimpleTimer",
    "ScopedMetric",
    "metrics_enabled",
    "StreamDecoder",
]
