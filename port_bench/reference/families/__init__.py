"""The plain reference's detector families, one module each, found by the
configuration's ``family`` key.

Each module gives:

* ``STRIDES``: the stride of each raw map, in the order of the maps;
* ``forward(net, x, cfg)``: the raw maps, built on ``models.Net`` from the
  shared blocks of ``models.py``;
* ``output_convs(cfg)``: (weight key, bias key, channel slice of the raw
  map, map index, std, bias values) of each output conv, the convs whose
  scale decides how scores spread (``core/weights.py`` scales each to
  ``std`` on a calibration batch and sets its bias);
* ``decode(maps, cfg)``: (boxes xyxy (B, N, 4), obj (B, N), cls max prob
  (B, N), cls id (B, N)) over every stage, in the port's flat candidate
  order; obj is 1 where the family has no objectness;
* ``loss(cfg, hyp, size, device)``: (loss(maps, ann, balances) -> (loss
  dict, new balances), the initial balances).

Adding a family adds a module here (and its loss, if it has a new one) and
edits none of the shared code.
"""

from __future__ import annotations

import importlib


def family(cfg: dict):
    """The module of the configuration's family."""
    return importlib.import_module(f"port_bench.reference.families.{cfg['family']}")
