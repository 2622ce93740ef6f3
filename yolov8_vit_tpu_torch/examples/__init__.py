"""Examples that drive the port end to end."""
