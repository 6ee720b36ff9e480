"""Samplers and densities."""
