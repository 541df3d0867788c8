"""Runtime support of the port."""
