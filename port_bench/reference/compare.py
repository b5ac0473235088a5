"""Detections of the program against the reference's, image by image.

A reference detection is matched by the program's detection of the same
class whose box is nearest (largest corner gap, in input pixels), where
that gap is at most ``MATCH_BOX_PX`` and the confidences differ by at most
``MATCH_CONF``; the same the other way round. Three numbers come out:

* ``unmatched_pct``: detections of either side with no match, per 100
  reference detections: a detection dropped, added or moved;
* ``conf_gap``: the largest confidence gap of a matched pair;
* ``box_gap_px``: the largest corner gap of a matched pair.

The matching tolerances only pair detections up; the limits on the three
numbers are in ``port_bench/checks/<cell>.json``.
"""

from __future__ import annotations

import torch

MATCH_BOX_PX = 2.0
MATCH_CONF = 0.02


def _one_side(a, b):
    """For each live row of a (B, Ka, 6), the nearest same-class live row of
    b (B, Kb, 6): (live mask of a, gap of the box, gap of the conf)."""
    live_a, live_b = a[..., 4] > 0, b[..., 4] > 0
    box = (a[:, :, None, :4] - b[:, None, :, :4]).abs().amax(-1)
    same = (a[:, :, None, 5] == b[:, None, :, 5]) & live_b[:, None, :]
    box = torch.where(same, box, torch.inf)
    gap, j = box.min(-1)
    conf = (a[..., 4] - torch.take_along_dim(b[..., 4], j, 1)).abs()
    return live_a, gap, conf


class Tally:
    """Running totals of the three numbers over many batches."""

    def __init__(self):
        self.ref = self.unmatched = 0
        self.conf_gap = self.box_gap = 0.0

    def add(self, got, want):
        """got, want: (B, K, 6) tensors on one device."""
        got, want = got.float(), want.float()
        live_w, box_w, conf_w = _one_side(want, got)
        live_g, box_g, conf_g = _one_side(got, want)
        ok_w = (box_w <= MATCH_BOX_PX) & (conf_w <= MATCH_CONF)
        ok_g = (box_g <= MATCH_BOX_PX) & (conf_g <= MATCH_CONF)
        self.ref += int(live_w.sum())
        self.unmatched += int((live_w & ~ok_w).sum() + (live_g & ~ok_g).sum())
        matched = live_w & ok_w
        if matched.any():
            self.conf_gap = max(self.conf_gap, float(conf_w[matched].max()))
            self.box_gap = max(self.box_gap, float(box_w[matched].max()))

    def numbers(self):
        return {"unmatched_pct": 100.0 * self.unmatched / max(self.ref, 1),
                "conf_gap": self.conf_gap, "box_gap_px": self.box_gap,
                "ref_detections": self.ref}
