"""Measurement scripts of the port, run on the machine with the card."""
