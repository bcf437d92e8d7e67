"""Votes to poses, and the serving entry point."""
