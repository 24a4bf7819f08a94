"""Runnable examples of the port (``python -m ...examples.<name>``)."""
