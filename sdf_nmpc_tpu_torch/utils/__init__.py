"""Workload helpers (the accuracy goldens)."""
