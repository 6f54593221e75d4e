# SPDX-License-Identifier: Apache-2.0
"""Published peaks of one NVIDIA H100 SXM (data sheet, at its full 700 W
power limit): HBM3 bandwidth and float32 outside the tensor cores.  A
roofline share is stated against these, with the card's power limit
printed beside it."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
