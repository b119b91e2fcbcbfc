"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3) at its full 700 W:
NVIDIA's data sheet, dense rates without sparsity.  Frozen here beside the
work counts that divide by them."""

PEAK_FP32_FLOPS = 67e12          # float32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12         # bfloat16 / float16 on the tensor cores
PEAK_INT8_OPS = 1979e12          # int8 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3
PEAKS = {"fp32": PEAK_FP32_FLOPS, "bf16": PEAK_BF16_FLOPS,
         "int8": PEAK_INT8_OPS}


def least_seconds(ops: dict, nbytes: float) -> float:
    """The least time the card needs for ``ops`` (operations by class, each
    class at its own peak, one after the other) and ``nbytes`` moved: the
    larger of the two."""
    by_ops = sum(n / PEAKS[k] for k, n in ops.items())
    return max(by_ops, nbytes / PEAK_BYTES_PER_S)
