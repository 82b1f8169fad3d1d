"""Predict step and image normalization."""
