"""The restarted GMRES driver and its restart policies."""
