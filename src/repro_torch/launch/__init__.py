"""Step builders, the continuous-batching LM serving loop and a launched
job's environment (``repro/launch``); mesh, sharding and the dry-run are
not ported (ROADMAP A.13)."""
