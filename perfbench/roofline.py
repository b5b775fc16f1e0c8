"""The least time the H100 could take for the tile kernels' work.

The work is counted from what any implementation of the four tile kernels
(raster forward, antialias forward, antialias backward, raster backward)
has to do for a step's inputs, not from the port's bins, caps or record
columns (:func:`reference.count_work` counts it): a z-test at each pixel
centre inside each face's screen box, interpolation and the raster
backward at each covered pixel, and the antialias forward and backward at
each pair of neighbouring pixels whose faces differ.  The float ops a unit
are the port's (``chip_smoke.py``, from the arithmetic in ``csrc/*.cu``).
The bytes are the inputs read once and the outputs written once: the
forward reads the views' clip positions, the vertices' shading, the faces
and their neighbours, and the backgrounds, and writes the image and the
four planes the backward needs (face id, two barycentrics, depth); the
backward reads the image's gradient, those planes, positions, shading,
faces and neighbours, and writes the gradients of positions and shading.
"""
from __future__ import annotations

__all__ = ["CHIP_SPECS", "FLOPS", "tile_work", "least_seconds"]

# published peaks of one H100 SXM5 80GB HBM3 at its 700 W limit (NVIDIA's
# data sheet; the port's profiling.CHIP_SPECS): float32 outside the tensor
# cores, bf16 on them without sparsity, HBM3 bandwidth
CHIP_SPECS = {
    "h100": {"fp32_tflops": 67.0, "bf16_tflops": 989.4, "hbm_gbps": 3350.0},
}
FLOPS = {
    "z_test": 22,        # raster_fwd: one face tested at one pixel
    "finish": 20,        # raster_fwd: interpolation at a covered pixel
    "rbwd": 100,         # raster_bwd: 18 gradient fields at a covered pixel
    "pair": 75,          # antialias: the three-edge crossing of one pair
    "pair_bwd": 60,      # aa_bwd: endpoint gradients of one pair
    "blend": 6,          # antialias: blend of one channel of one pair
}
F32 = 4
PLANES = 4               # face id, u, v, depth at each pixel


def tile_work(w: dict) -> tuple:
    """(float ops, bytes) of one step's four tile kernels from the counts
    ``w`` (``reference.count_work``)."""
    D = w["channels"]
    f = FLOPS
    flops = (f["z_test"] * w["z_tests"] + f["finish"] * w["covered"]
             + (f["pair"] + f["blend"] * D) * w["pairs"]
             + f["rbwd"] * w["covered"]
             + (f["pair"] + f["pair_bwd"] + 2 * f["blend"] * D) * w["pairs"])
    C, V, F, P = w["views"], w["verts"], w["faces"], w["pixels"]
    mesh = C * V * 4 + V * 3 + F * 6            # positions, shading, tables
    fwd = mesh + P * 4 + P * D + P * PLANES     # + backgrounds; image, planes
    bwd = P * D + P * PLANES + mesh + C * V * 4 + V * 3
    return float(flops), float(F32 * (fwd + bwd))


def least_seconds(flops: float, nbytes: float, chip: str = "h100") -> float:
    spec = CHIP_SPECS[chip]
    return max(nbytes / (spec["hbm_gbps"] * 1e9),
               flops / (spec["fp32_tflops"] * 1e12))
