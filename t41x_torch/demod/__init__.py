"""Demodulators (torch): AM, synchronous AM, narrow-band FM."""
