"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peak(kind: str, name: str = DEFAULT) -> float:
    """A peak of the card named ``name`` (the H100 SXM's for an unknown
    name)."""
    return PEAKS.get(name, PEAKS[DEFAULT])[kind]
