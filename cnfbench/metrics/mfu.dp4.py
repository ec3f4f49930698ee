"""The data-parallel train step's share of the card's peak, in %:
``mfu.train``'s reading, of rank 0's card."""

from cnfbench import cells

read = cells.reader("mfu.train")
