"""A launched process's environment (``repro/launch/env.py``), the part
the card needs: tcmalloc's large-allocation report raised so that, in an
image that preloads tcmalloc, multi-GB parameter stacks do not print on
every round.  Nothing here preloads tcmalloc: the reference's cluster
Job does not either (``host_env(tcmalloc=False)``).  The reference's XLA
flags have no meaning here.

This is an overlay for a process about to be started (a cluster Job's
container), never applied in place.
"""
from __future__ import annotations

from typing import Dict

# 60 GB: parameter stacks of a few GB must not trip tcmalloc's
# large-alloc report on every round
TCMALLOC_REPORT_THRESHOLD = "60000000000"


def host_env() -> Dict[str, str]:
    """Env-var overlay for a launched process (no side effects)."""
    return {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD":
            TCMALLOC_REPORT_THRESHOLD}
