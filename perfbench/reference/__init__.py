"""The plain reference the benchmark holds the port to (imports nothing of the port)."""
