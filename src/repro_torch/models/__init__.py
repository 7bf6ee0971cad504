"""Model definitions of the port: the dense transformer family."""
