"""Runnable examples of the port: the kernel tour and the serving demo."""
