"""Decode entry points of the port."""
