"""The registration driver and the session object (PyTorch)."""
