"""Engine and training loop of the port."""
