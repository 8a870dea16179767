from pir_tpu_torch.utils.math import (
    next_power_two,
    ceil_log2,
    floor_log2,
    ipow,
    invert_mod,
    generate_galois_elts,
)

__all__ = [
    "next_power_two",
    "ceil_log2",
    "floor_log2",
    "ipow",
    "invert_mod",
    "generate_galois_elts",
]
