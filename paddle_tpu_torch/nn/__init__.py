"""The layers the port's models use."""
