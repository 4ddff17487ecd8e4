"""Step builders and the continuous-batching LM serving loop
(``repro/launch``); mesh, sharding and the dry-run are not ported
(ROADMAP A.13)."""
