"""Whole-room evaluation (port of `pointseg.utils.sliding_window` and
`pointseg.utils.evaluation`)."""
