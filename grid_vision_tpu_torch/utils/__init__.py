"""Utilities of the torch port."""
