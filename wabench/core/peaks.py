"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): what a roofline share is taken against."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores (f64 on
                               # the tensor cores alike)


def bound_s(ops: float, nbytes: float):
    """(seconds, "operations" | "bytes"): the least time the card could
    take, the larger of the two."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
