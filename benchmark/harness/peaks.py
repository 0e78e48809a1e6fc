"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, no sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "int8": 1979e12,  # int8 tensor cores
    "fp8": 1979e12,
    "bf16": 989e12,  # bf16 / fp16 tensor cores
    "fp16": 989e12,
    "tf32": 495e12,
    "f32": 67e12,  # CUDA cores, outside the tensor cores
}


def least_seconds(nbytes: float, ops: float, arith: str):
    """(the chip's least time for the work, "bytes" or "ops": which of the
    two bounds it)."""
    tb = nbytes / HBM_BYTES_PER_S
    to = ops / OPS_PER_S[arith]
    return (tb, "bytes") if tb >= to else (to, "ops")
