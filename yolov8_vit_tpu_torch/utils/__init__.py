"""Utilities of the PyTorch port: checkpoints, profiling, the detect
head's densify / fit."""
