"""Scan I/O (numpy only)."""
