"""Hardware constants of the card the port runs on (``repro/roofline``).

``hw`` holds the H100's peak rates, the denominators of every kernel's
bound in ``chip_smoke.py`` and of the mesh's collective times in
:func:`repro_torch.launch.federated.federated_round_cost`.  The
reference's HLO parser (``analysis.py``) has no counterpart yet."""
from repro_torch.roofline import hw

__all__ = ["hw"]
