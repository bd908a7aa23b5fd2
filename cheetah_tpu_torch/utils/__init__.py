"""Utilities of the PyTorch port: physics helpers, maths, statistics, devices."""
