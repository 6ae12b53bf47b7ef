"""Benchmark driver of the port (driver.py)."""
