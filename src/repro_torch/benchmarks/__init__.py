"""Twins of the reference's ``benchmarks/`` sweeps, measured on the card."""
