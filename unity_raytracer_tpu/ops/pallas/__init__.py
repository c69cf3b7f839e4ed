"""Pallas GPU kernels (Triton route) — the hand-written tier under the
XLA-compiled ops."""
