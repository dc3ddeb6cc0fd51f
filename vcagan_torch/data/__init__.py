"""GRID and LRS data: clip sources, host collation, the prefetch thread and the input pipelines on the device."""
