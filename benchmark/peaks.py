"""The card's peaks and the splat kernels' operations per unit of work: the
yardstick's constants, frozen here so that a change to the program cannot
move them.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet; dense
rates): float32 outside the tensor cores, and HBM3 bandwidth.  The program
runs float32 with TF32 off, so the float32 rate is the step's peak.
"""
PEAK_F32 = 67e12        # FLOP/s
PEAK_BYTES = 3.35e12    # bytes/s

# operations per unit of splat work
OPS_PAIR = 5            # a (splat, pixel) test: dc, dr, dc^2 + dr^2, w
OPS_LOG1P = 20          # forward, per pair with w > 0: clip, log1p, add
OPS_BWD_HIT = 9         # backward, per pair with 0 < w < 1 - 1e-5: 1 - w,
                        # reciprocal, three multiplies, two FMAs
OPS_EXP = 20            # forward, per covered pixel: 1 - exp(acc)
OPS_COT = 2             # backward, per covered pixel: -g * (1 - mask)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs for `ops` float32 operations and
    `nbytes` bytes to or from its memory."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)
