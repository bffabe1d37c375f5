"""Plain references of the benchmark's configurations, in NumPy and
SciPy.  Nothing here imports the port, JAX or the JAX package: every
input comes from the harness, and what the port derived from it
(resampled buffers, filter taps, normalised impulse responses, dither)
is worked out again here.

Each render takes `q`, a rounding applied after every operation
(`precision.rounder`): float64 for the reference, a lower precision for
the control that the limits are set against.
"""
