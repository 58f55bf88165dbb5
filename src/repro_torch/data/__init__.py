"""Synthetic data streams and the host input pipeline of the port."""
