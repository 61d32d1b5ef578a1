"""Whole-room evaluation, measurement, memory telemetry and plots (port
of `pointseg.utils`: `sliding_window`, `evaluation`, `benchmark`,
`memory`, `visualize`)."""
