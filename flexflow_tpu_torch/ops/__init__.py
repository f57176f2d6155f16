"""Operator library. Importing this package registers every ported op."""

from . import (attention, conv, dropout, element_binary, element_unary,  # noqa: F401
               embedding, fused, linear, moe_ops, norm, recurrent, reduce, softmax,
               structural)
