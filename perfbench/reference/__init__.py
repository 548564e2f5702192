"""The plain reference: the MU-Diff networks, sampler and training iteration in float32 PyTorch."""
