"""The benchmark's plain reference: float32 PyTorch, importing nothing of
the program, that decides ``correct``."""
