"""Independent conformance decoder for DSV2 v2.8 streams.

A second, self-contained decode implementation (numpy only, no imports
from the port's codec) mirroring the role of the reference's
single-header decoder (ref: single-header-decoder/dsv28dec.h:264-336 API
surface); the port's copy of `dsv2_tpu.conformance`.
"""
from .d28dec import ConformanceDecoder, decode_stream, decode_file

__all__ = ["ConformanceDecoder", "decode_stream", "decode_file"]
