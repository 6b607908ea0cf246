"""Registration: point clouds, bounding boxes, template scoring and alignment."""
