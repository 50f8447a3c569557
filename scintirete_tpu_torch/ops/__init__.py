"""Compute ops: distances, exact top-k, and the two hand-written kernels
(pivot-entry scan, builder lane scan) with their plain torch versions."""
