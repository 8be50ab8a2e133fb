"""Weight I/O, image metrics and float32 precision."""
