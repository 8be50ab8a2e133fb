"""Weight I/O and image metrics."""
