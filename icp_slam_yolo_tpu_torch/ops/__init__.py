"""Geometry, voxel, nearest-neighbour and raster ops of the port."""
