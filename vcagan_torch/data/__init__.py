"""GRID data: clip sources, host collation, the prefetch thread and the input pipeline on the device."""
