"""Run-configuration helpers copied from ``repro.experiment``."""
