"""Scan registration."""
