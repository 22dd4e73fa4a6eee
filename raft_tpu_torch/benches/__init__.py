"""Micro-benchmark suites on the port (`suites.py`)."""
