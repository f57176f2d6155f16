"""Small utilities (the dot-file writer)."""
