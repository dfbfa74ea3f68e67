"""Search core of the PyTorch port: problem algebra, specs, mappings,
the numpy oracle, the differentiable model on tensors, rounding and the
co-search engines."""
