"""Distributed helpers of the port (only what serving needs so far)."""
