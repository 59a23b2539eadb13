"""Bit-vector containers and their host metadata."""
