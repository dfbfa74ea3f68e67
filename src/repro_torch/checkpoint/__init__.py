"""Atomic on-disk checkpoints (`checkpoint`), in the reference's
format."""
