"""Torch formulations of the MFCC stages and the kernel wrappers."""
