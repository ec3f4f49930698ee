"""The device's idle share of the data-parallel cell's traced window under
the program's spans, in %: ``program_idle.train``'s reading, of rank 0's
card."""

from cnfbench import cells

read = cells.reader("program_idle.train")
