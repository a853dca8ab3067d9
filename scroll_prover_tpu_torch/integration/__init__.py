"""Circuits that drive the port's main path end to end."""
