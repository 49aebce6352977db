"""Host utilities (NumPy) and the native-source builder."""
