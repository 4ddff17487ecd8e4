"""FedPhD core algorithms: the trainer, aggregation, SH scores, edge
selection and structured pruning."""
