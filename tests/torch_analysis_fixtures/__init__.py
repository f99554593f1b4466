"""Seeded-defect fixtures for the port's static checkers (read as data,
never imported by the tests)."""
