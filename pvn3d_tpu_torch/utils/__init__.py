"""Utilities of the port: device choice, assets, weights."""
