"""Model configurations of the port (the vision configs of the paper)."""
