"""Serving runtime of the PyTorch port: the fault taxonomy (`faults`),
task-state checkpoints (`search_checkpoint`) and seeded chaos
injection (`chaos`)."""
