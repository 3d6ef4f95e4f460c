"""Masked per-LUN-group lowest-wear selection (the engine's ALLOC
kernel)."""
