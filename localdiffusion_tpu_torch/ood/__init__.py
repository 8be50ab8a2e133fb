"""Stage A of this slice: the manual mask."""
