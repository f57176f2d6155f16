"""Keras-style frontend pieces of the port. Only the weight regularizers
so far (``FFModel.dense(kernel_regularizer=...)``); the rest of the
frontend is ROADMAP queue A12."""

from . import regularizers  # noqa: F401
