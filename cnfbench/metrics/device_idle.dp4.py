"""The device's idle share of the data-parallel cell's traced window, in %:
``device_idle.train``'s reading, of rank 0's card."""

from cnfbench import cells

read = cells.reader("device_idle.train")
