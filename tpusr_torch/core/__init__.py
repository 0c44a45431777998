"""Padding, patch extraction and the hand-written conv kernels."""
