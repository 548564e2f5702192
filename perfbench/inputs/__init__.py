"""Seeded inputs: weights and phantom slices, made on the device."""
