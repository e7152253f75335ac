"""Inference ops: TTA, post-processing, and the hand-written kernels."""
