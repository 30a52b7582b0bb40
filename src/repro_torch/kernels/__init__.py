"""Kernels of the port: the Hopper MTTKRP kernel, its wrappers and oracles."""
