"""The pallet detector: the v8 YOLO family, its decode and the host-facing
`Detector`."""
