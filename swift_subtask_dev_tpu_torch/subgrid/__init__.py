"""Subgrid physics of the port: constant-Lambda cooling and the EAGLE
models (table cooling, entropy floor, chemistry, star formation, thermal
feedback, enrichment)."""
