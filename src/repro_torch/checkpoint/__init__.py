"""Versioned asynchronous checkpoints (the port of ``repro.checkpoint``),
on the reference's on-disk layout."""
