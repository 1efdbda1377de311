"""Named models and the Flax -> PyTorch weight bridge."""
