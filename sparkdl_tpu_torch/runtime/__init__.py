"""Batch runners of the port."""
