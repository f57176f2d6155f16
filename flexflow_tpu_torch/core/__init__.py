"""Graph IR: tensors, layers, ops."""
