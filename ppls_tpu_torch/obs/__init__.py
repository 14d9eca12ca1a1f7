"""obs of the PyTorch port: host-only copies of the JAX package's metrics
registry, span tracer and telemetry handle (see the package docstring)."""
