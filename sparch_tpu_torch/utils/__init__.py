"""Utilities: device timing."""
