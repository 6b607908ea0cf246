"""Mesh extraction: the triangle mesh container and the grid mesher."""
