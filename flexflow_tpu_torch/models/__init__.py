"""Model zoo (the slice ports the Transformer)."""
