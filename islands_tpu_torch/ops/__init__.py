"""Distance, merge, sketch and kernel ops of the port."""
