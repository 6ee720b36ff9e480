"""Gibbs blocks, the HDP-LPCM sweep and its driver."""
