"""Compute ops: the rasterizer, crop-resize matmuls, segment/group ops."""
