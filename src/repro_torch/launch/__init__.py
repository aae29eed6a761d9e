"""Serving driver and continuous-batching scheduler."""
