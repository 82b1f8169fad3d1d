"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): HBM bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s
outside the tensor cores."""

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of bytes over the HBM
    rate and operations over the dtype's peak."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])
