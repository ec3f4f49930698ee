"""Conditional sampling."""
