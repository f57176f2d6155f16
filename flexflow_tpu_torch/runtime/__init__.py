"""Compiler, FFModel and initializers."""
