"""Plain reference of the undirected case-control likelihood (the reference
package's case_control_likelihood.py): each node's exact terms of its
edges plus its sampled controls' non-edge terms, scaled to its non-edges.

* :func:`conflict_colors` colours the nodes so no two of one class share
  an edge at any time, by the balanced greedy rule of the chromatic scan
  (nodes in ``RandomState(seed).permutation(n)`` order, each taking the
  least-loaded colour none of its neighbours has): the order in which the
  chromatic scan updates the classes.
* :func:`draw_controls` is the control draw of a sweep: ``m`` nodes a node,
  uniform with replacement from a generator seeded by the control seed and
  the sweep count of the draw, -1 where the draw is the node itself or of
  its colour class.

Node j's log-likelihood at time t is
sum_{i in edges} (eta - softplus(eta)) - s_tj sum_{valid controls k}
softplus(eta_jk), s_tj = (n - deg_tj - 1) / max(#valid, 1), a control
valid at t when it is a node and not an edge partner of j at t; the
network's is half the sum over (t, j), every dyad lying in two rows.
"""
import numpy as np
import torch


def conflict_colors(Y, seed):
    """(n,) int64 colour of each node of the network Y (T, n, n), on Y's
    device."""
    Yh = Y.cpu().numpy()
    T, n, _ = Yh.shape
    union = Yh.any(axis=0)
    union = union | union.T
    np.fill_diagonal(union, False)
    rng = np.random.RandomState(seed)
    colors = np.full(n, -1, dtype=np.int64)
    loads = []
    for j in rng.permutation(n):
        taken = set(colors[union[j]][colors[union[j]] >= 0].tolist())
        free = [c for c in range(len(loads)) if c not in taken]
        if free:
            c = min(free, key=lambda k: (loads[k], k))
        else:
            c = len(loads)
            loads.append(0)
        colors[j] = c
        loads[c] += 1
    return torch.as_tensor(colors, device=Y.device)


def draw_controls(colors, m, ctrl_seed, it):
    """(n, m) int64 controls of the draw at sweep count ``it``."""
    n = colors.shape[0]
    g = torch.Generator(device=colors.device).manual_seed(
        int(ctrl_seed) * 2 ** 32 + int(it))
    cand = torch.randint(0, n, (n, m), generator=g, device=colors.device)
    node = torch.arange(n, device=colors.device)[:, None]
    bad = (cand == node) | (colors[cand] == colors[:, None])
    return torch.where(bad, torch.full_like(cand, -1), cand)


class CaseControlLik:
    """The case-control estimator with the controls ``ctrl`` (n, m): row
    weights A = y and B = y + s_tj * (the valid controls' counts)."""

    def __init__(self, Y, ctrl):
        self.Y, self.ctrl = Y, ctrl
        self.n = Y.shape[-1]

    def rows(self, a, t, js):
        Y = self.Y[t, js]
        A = Y.to(a.dtype)
        ctrl = self.ctrl[js]
        safe = torch.clamp_min(ctrl, 0)
        valid = (ctrl >= 0) & (torch.gather(Y, 1, safe) == 0)
        counts = torch.zeros_like(A)
        counts.scatter_add_(1, safe, valid.to(a.dtype))
        n_valid = torch.clamp_min(valid.sum(1), 1).to(a.dtype)
        scale = a(a(self.n - A.sum(1) - 1.0) / n_valid)
        return A, a(A + a(scale[:, None] * counts))
