"""Bipartite assignment on the device: the auction algorithm (counterpart
of ``ops/matching.py``).

Bertsekas' Jacobi auction: every unassigned valid row bids for its best
column with an increment of (best - second best + eps), and every column
goes to its highest bidder; a row that has lost its column bids again.
The result is within ``T * eps`` of the optimal cost.  The JAX function
runs one ``(T, Q)`` problem in a ``lax.while_loop`` and is vmapped over
the batch; here one call takes a batch ``(B, T, Q)`` of problems, the
images and the deep-supervision predictions of a train step together, and
every round is a few batched operations on the device.

The loop's exit test reads a flag back to the host, one synchronisation
per CHECK_EVERY rounds.  A round in which no row bids changes nothing,
so the rounds run past a problem's convergence leave its result as the
JAX loop's; ``max_iters`` caps the rounds as there.  Ties go to the first
column (bids) and the first row (owners), as ``jnp.argmax`` takes them:
``torch.argmax`` returns the first maximal index too.

``stats`` counts the calls, the rounds in which some row bid and the host
synchronisations since it was last cleared.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1e30
CHECK_EVERY = 8  # rounds between two reads of the exit flag

stats = {"calls": 0, "rounds": 0, "syncs": 0}


def auction_assignment(cost: torch.Tensor,
                       valid_rows: Optional[torch.Tensor] = None,
                       eps: float = 1e-4, max_iters: int = 5000
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-cost assignment of T rows to Q columns (T <= Q) for each of B
    problems.

    cost (B, T, Q); valid_rows (B, T) bool -- invalid rows never bid.
    Returns (col_of_row (B, T) int64, -1 for an unassigned row; owner
    (B, Q) int64, the row owning each column or -1).  A valid row ends
    unassigned only if ``max_iters`` runs out first: gate every index use
    on ``col >= 0`` (a negative index is a device assert on CUDA)."""
    B, T, Q = cost.shape
    assert T <= Q, (T, Q)
    device = cost.device
    benefit = -cost.detach().float()
    if valid_rows is None:
        valid_rows = torch.ones((B, T), dtype=torch.bool, device=device)
    rows = torch.arange(T, device=device)
    prices = torch.zeros((B, Q), dtype=torch.float32, device=device)
    owner = torch.full((B, Q), -1, dtype=torch.long, device=device)
    bid_rounds = torch.zeros((), dtype=torch.long, device=device)
    neg = torch.tensor(NEG, dtype=torch.float32, device=device)
    stats["calls"] += 1

    def unassigned():
        mine = owner[:, None, :] == rows[None, :, None]     # (B, T, Q)
        return valid_rows & ~mine.any(dim=2)

    it = 0
    while it < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            bidding = unassigned()                          # (B, T)
            values = benefit - prices[:, None, :]           # (B, T, Q)
            best_v = values.amax(dim=2)
            best_j = values.argmax(dim=2)
            chosen = torch.nn.functional.one_hot(best_j, Q).bool()
            second = torch.where(chosen, neg, values).amax(dim=2)
            bid = prices.gather(1, best_j) + best_v - second + eps
            offers = torch.where(bidding[..., None] & chosen,
                                 bid[..., None], neg)       # (B, T, Q)
            top_bid = offers.amax(dim=1)                    # (B, Q)
            top_row = offers.argmax(dim=1)
            has_bid = top_bid > NEG / 2
            prices = torch.where(has_bid, top_bid, prices)
            owner = torch.where(has_bid, top_row, owner)
            bid_rounds += bidding.any()
            it += 1
        stats["syncs"] += 1
        if not bool(unassigned().any()):
            break
    stats["rounds"] += int(bid_rounds)

    mine = owner[:, None, :] == rows[None, :, None]         # (B, T, Q)
    col_of_row = torch.where(mine.any(dim=2), mine.long().argmax(dim=2),
                             torch.full_like(owner[:, :T], -1))
    return col_of_row, owner
