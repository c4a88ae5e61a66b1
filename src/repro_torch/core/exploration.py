"""Adaptive epsilon-greedy exploration (paper §3.4.2, Eq. 9).

The base decay d is auto-derived from the episode budget so epsilon reaches
eps_min from eps0 over the run; when no feasible configurations have been
discovered the decay is blended toward slower: d' = 1 - (1-d)*0.1.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EpsilonSchedule:
    eps0: float = 0.5
    eps_min: float = 0.1
    budget: int = 4613          # paper Table 14: episodes per node

    def __post_init__(self) -> None:
        self.eps = self.eps0
        # reach eps_min in ~80% of the budget under steady decay
        steps = max(1, int(0.8 * self.budget))
        self.d = (self.eps_min / self.eps0) ** (1.0 / steps)
        self.d_slow = 1.0 - (1.0 - self.d) * 0.1       # Eq. 9 d'

    def step(self, found_feasible: bool) -> float:
        decay = self.d if found_feasible else self.d_slow
        self.eps = max(self.eps_min, self.eps * decay)
        return self.eps
