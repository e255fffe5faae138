"""The port's standard library: indexes."""
