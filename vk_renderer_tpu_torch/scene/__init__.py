"""Host-side scene loading (NumPy)."""
