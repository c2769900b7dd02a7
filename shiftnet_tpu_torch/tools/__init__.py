"""Port CLIs and weight interop."""
