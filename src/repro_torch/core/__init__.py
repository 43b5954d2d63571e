"""Core DiP layout helpers (port of ``repro.core``; permutation only)."""
