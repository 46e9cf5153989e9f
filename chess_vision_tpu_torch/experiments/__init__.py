"""Measurement scripts of the port, counterparts of the repository's
``experiments/`` directory."""
