"""Hand-written Hopper kernels, their builds and their plain versions."""
