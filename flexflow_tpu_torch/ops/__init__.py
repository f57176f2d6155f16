"""Operator library. Importing this package registers every ported op."""

from . import attention, linear, moe_ops, softmax  # noqa: F401
