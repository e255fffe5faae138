"""Device-dispatch plane of the port."""
