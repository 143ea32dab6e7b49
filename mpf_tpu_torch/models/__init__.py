"""Blocked LU drivers."""
