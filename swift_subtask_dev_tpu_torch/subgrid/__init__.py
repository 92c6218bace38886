"""Subgrid physics of the port: constant-Lambda cooling."""
