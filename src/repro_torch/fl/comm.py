"""Communication-cost model (``repro/fl/comm.py``; paper §V-C, after
ShapeFL): C_ne = 0.002 d_e V client<->edge, C_ce = 0.02 d_c V
edge<->cloud, d_c = 10 d_e, V the bytes sent."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CommModel:
    d_e: float = 1.0
    d_c: float = 10.0
    k_edge: float = 0.002
    k_cloud: float = 0.02

    def client_edge(self, volume_bytes: float) -> float:
        return self.k_edge * self.d_e * volume_bytes

    def edge_cloud(self, volume_bytes: float) -> float:
        return self.k_cloud * self.d_c * volume_bytes
