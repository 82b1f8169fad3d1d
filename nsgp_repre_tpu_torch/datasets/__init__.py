"""Image loading and resizing."""
