"""Operator library. Importing this package registers every ported op."""

from . import (attention, dropout, element_binary, element_unary, embedding,  # noqa: F401
               linear, moe_ops, norm, softmax)
