"""HTTP serving surface: the SLAM control panel with its SSE and MJPEG streams."""
