"""Client-side training and the federation's bookkeeping: local steps,
communication cost, byte counts and round records."""
