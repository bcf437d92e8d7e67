"""Point ops of the port: sampling, grouping, interpolation."""
