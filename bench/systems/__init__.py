"""The system under test, one module per model family: each builds the
port's serving seam for a configuration from the benchmark's inputs."""
