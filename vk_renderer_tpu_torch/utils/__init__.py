"""Host utilities (NumPy), the native-source builder and the frame's
spans and counters."""
