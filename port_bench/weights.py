"""Random weights made on the card from ``--seed``, by a configuration's
rules, for the port and the reference alike.

Each leaf of the reference recogniser's state dict takes the first rule
whose pattern matches its name (``re.search``):

- ``{"lecun": g}``: N(0, g^2 / fan_in), fan_in the product of all but the
  last dimension (Flax layouts: Dense (in, out), conv (kh, kw, in, out));
- ``{"normal": s}``: N(0, s^2);
- ``{"around": [m, s]}``: m + N(0, s^2);
- ``{"const": v}``: v (EfficientNet running statistics before they are
  calibrated).

All random leaves come out of one ``torch.randn`` on the card, in state
dict order, so one seed gives the same weights on every run.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List

import torch


def make(shapes: Dict[str, torch.Size], rules: List[list], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every leaf of ``shapes``
    (an ordered name -> shape mapping)."""
    chosen = {}
    for name, shape in shapes.items():
        rule = next((r for pattern, r in rules if re.search(pattern, name)), None)
        if rule is None:
            raise ValueError(f"no weight rule matches {name}")
        chosen[name] = rule
    total = sum(math.prod(s) for n, s in shapes.items() if "const" not in chosen[n])
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        rule, n = chosen[name], math.prod(shape)
        if "const" in rule:
            out[name] = torch.full(shape, float(rule["const"]), device=device)
            continue
        z = flat[at:at + n].view(shape)
        at += n
        if "lecun" in rule:
            out[name] = z * (rule["lecun"] / math.sqrt(math.prod(shape[:-1])))
        elif "normal" in rule:
            out[name] = z * rule["normal"]
        else:
            mean, std = rule["around"]
            out[name] = z * std + mean
    return out
