"""Fused candidate selection: one global top-k over stage-concatenated score
planes, then sparse masked gathers of the K winning rows from each stage."""

from __future__ import annotations

import torch

from ..ops.nms import stable_topk

__all__ = ["topk_gather"]


def topk_gather(stage_scores, k, groups):
    """Global top-k + sparse per-stage row gathers.

    Args:
      stage_scores: list of (B, Ns) f32 score planes, one per stage; zeros
        mark gated slots. Their concatenation order defines the global index.
      k: number of candidates to keep (clamped to the total N).
      groups: list of per-stage tensor lists; ``groups[g][s]`` is (B, Ns_s, Cg).

    Returns:
      (score_k (B, K), idx_k (B, K) global indices, gathered) with
      ``gathered[g]`` the (B, K, Cg) rows of ``groups[g]`` at ``idx_k``.
      Equal scores keep the lower index first.
    """
    scores = torch.cat(stage_scores, dim=1)  # (B, N)
    score_k, idx_k = stable_topk(scores, min(k, scores.shape[-1]))

    gathered = []
    for group in groups:
        out = None
        offset = 0
        for stage in group:
            ns = stage.shape[1]
            local = idx_k - offset
            in_stage = (local >= 0) & (local < ns)
            rows = torch.take_along_dim(stage, local.clamp(0, ns - 1)[..., None], dim=1)
            out = rows if out is None else torch.where(in_stage[..., None], rows, out)
            offset += ns
        gathered.append(out)
    return score_k, idx_k, gathered
