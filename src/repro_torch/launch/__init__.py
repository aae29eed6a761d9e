"""Serving driver, continuous-batching scheduler and the train step."""
