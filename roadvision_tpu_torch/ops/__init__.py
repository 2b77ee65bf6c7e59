"""Tensor ops of the port: colour, CLAHE, median, letterbox, NMS."""
