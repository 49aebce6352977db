"""Frame graph and host driver."""
