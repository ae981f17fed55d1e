"""Shared building blocks of the port."""
