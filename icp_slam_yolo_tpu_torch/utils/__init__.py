"""Host-side helpers (numpy and the standard library only)."""
