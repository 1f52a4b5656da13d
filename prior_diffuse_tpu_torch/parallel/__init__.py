"""Data parallelism: one process a device, one global batch split over them."""
