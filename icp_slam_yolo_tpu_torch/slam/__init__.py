"""The SLAM step, its replay and the host API."""
