"""Operator library. Importing this package registers every ported op."""

from . import attention, linear  # noqa: F401
