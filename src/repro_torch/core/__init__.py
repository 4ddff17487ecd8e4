"""FedPhD core algorithms ported so far: structured-pruning masks."""
