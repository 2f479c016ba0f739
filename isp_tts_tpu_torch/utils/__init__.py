"""Masks and device selection."""
