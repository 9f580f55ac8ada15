"""Utilities the port keeps its own copy of."""
