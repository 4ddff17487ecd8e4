"""Step builders, the LM training and serving launchers and a launched
job's environment (``repro/launch``); mesh, sharding and the dry-run are
not ported (ROADMAP A.13)."""
