"""CUDA kernels a step of the data-parallel cell:
``kernels_per_step.train``'s reading, of rank 0's card."""

from cnfbench import cells

read = cells.reader("kernels_per_step.train")
