"""Evaluation harness of the port (windowed deblur inference + metrics)."""
