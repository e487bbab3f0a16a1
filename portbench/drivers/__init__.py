"""Traffic drivers, one module a ``driver`` named by a traffic file."""
