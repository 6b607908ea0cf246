"""3D reconstruction metrics."""
