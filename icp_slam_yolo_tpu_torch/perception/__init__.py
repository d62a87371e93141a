"""Perception geometry: stereo triangulation, pallet pose, OBB heuristics, PnP."""
