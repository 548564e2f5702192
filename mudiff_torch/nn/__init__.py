"""Layers, blocks and fused stems of the port (NHWC, float32 parameters)."""
