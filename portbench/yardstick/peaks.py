"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  A card set below 700 W reaches less; the
result's ``device`` names the card's power limit beside every share."""

FP32 = 67e12  # FLOP/s, CUDA cores
FP64_TENSOR = 67e12  # FLOP/s, FP64 on the tensor cores
TF32 = 495e12  # FLOP/s, dense TF32 tensor cores
BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
HBM = 3.35e12  # bytes/s


def bound_s(ops: float, bytes_: float, flops: float) -> float:
    """Least seconds of a piece of work: the larger of its operations over
    their peak and its bytes over the memory rate."""
    return max(ops / flops, bytes_ / HBM)
