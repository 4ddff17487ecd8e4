"""Analytic cost accounting."""
