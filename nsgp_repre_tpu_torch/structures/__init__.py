"""Box structures and fixed-capacity sample containers."""
