"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
its 700 W limit), copied with ``chip_smoke.py``'s (:303-306) and widened to
the precisions the configurations state."""

HBM_BYTES_PER_S = 3.35e12
PEAK = {
    "int8": 1979e12,      # tensor-core int8 operations/s
    "bfloat16": 989e12,   # tensor-core bf16 FLOP/s
    "tf32": 495e12,       # tensor-core TF32 FLOP/s (a configuration that allows it)
    "float32": 67e12,     # float32 outside the tensor cores
}


def rate(precision: str, tf32_allowed: bool = False) -> float:
    """The peak a configuration's part runs at: float32 takes TF32's rate
    only where the configuration allows TF32."""
    if precision == "float32" and tf32_allowed:
        return PEAK["tf32"]
    return PEAK[precision]


def least_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time for the work: its operations at the peak or its
    bytes at the memory rate, whichever is longer."""
    return max(ops / rate(precision), nbytes / HBM_BYTES_PER_S)
