"""Recipes over the port's entry points (see each subpackage)."""
