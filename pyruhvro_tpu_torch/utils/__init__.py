"""Seeded data generators of the port."""
