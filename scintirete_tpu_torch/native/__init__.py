"""Native (C++) runtime components, loaded via ctypes with Python fallbacks."""
