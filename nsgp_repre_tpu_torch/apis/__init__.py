"""User-facing inference API."""
