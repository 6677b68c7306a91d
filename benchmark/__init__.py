"""The harness of the port's benchmark (README.md)."""
