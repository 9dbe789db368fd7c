"""Serving steps and request batching."""
