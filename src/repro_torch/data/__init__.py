"""Calibration and evaluation data (the synthetic corpus)."""
