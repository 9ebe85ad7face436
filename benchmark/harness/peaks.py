"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit) and the operations of one ray-triangle test."""
from __future__ import annotations

PEAK_FP32 = 67e12       # FLOP/s in float32 outside the tensor cores
PEAK_BYTES = 3.35e12    # bytes/s of HBM3

# fp32 operations per ray-triangle test: three 6-term side products (11
# each), n.d (5), d0 - n.o (6), then the divide (closest hit) or the two
# range terms and their product (any hit).
OPS_PER_TEST = {"closest": 33 + 5 + 6 + 1, "any": 33 + 5 + 6 + 5}


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_FP32)

