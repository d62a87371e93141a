"""Sensor acquisition: camera capture (the LiDAR drivers are not ported yet)."""
