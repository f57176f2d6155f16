"""Serving: the classic one-shot inference engine."""
