"""Graph, configuration, build and search of the port."""
