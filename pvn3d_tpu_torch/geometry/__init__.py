"""Rigid-transform geometry of the port."""
