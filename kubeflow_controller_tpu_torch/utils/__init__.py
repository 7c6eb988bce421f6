"""Small helpers the port keeps its own copies of."""
