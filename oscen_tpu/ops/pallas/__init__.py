"""Pallas kernels (Triton route): the lane-parallel recurrence scan and
the fused additive voice."""
